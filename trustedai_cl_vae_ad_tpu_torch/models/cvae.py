"""Convolutional VAE core in PyTorch.

Counterpart of ``trustedai_cl_vae_ad_tpu/models/cvae.py`` (the JAX package's
flax modules), with the same behaviour:

  * ``z = mean + 0.5 * logvar + eps`` — not the textbook
    ``mean + exp(0.5*logvar) * eps``; eps ~ N(0, 1) only when training,
    zeros otherwise, and callers may inject it.
  * ``encode(x, training=True)`` adds N(0, beta) input noise, but
    ``call`` / ``call_detailed`` never pass ``training`` into encode, so that
    path is dead in the forward, exactly as in the JAX core.
  * encoder: TF-SAME stride-2 3x3 convs with relu, a row-major HWC flatten,
    the optional ``encoder_dense_filters`` Dense, then Dense(2*latent).
    decoder: Dense with relu, reshape to (dw, dh, ddf) in HWC order, TF-SAME
    stride-2 transposed convs with relu, a stride-1 transposed conv (linear).

Public functions take and return NHWC tensors like the JAX core; the modules
convert to NCHW inside. Submodules carry the flax parameter names
(``Conv_0``, ``Dense_0``, ``ConvTranspose_0`` ...), so ``bridge.py`` maps a
flax tree onto the state dict by name. The TPU-only layout alternates of the
JAX core (space-to-depth and sub-pixel evaluation) are not ported: the keys
``model.s2d_input`` and ``model.fast_vjp`` are accepted and do nothing.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trustedai_cl_vae_ad_tpu_torch.ops.convt import conv_transpose_same, same_pads


def normalize_image_input(x: torch.Tensor) -> torch.Tensor:
    """uint8 frames are raw 0-255 pixels and normalize to [0, 1]; float
    inputs are already normalized and widen to float32."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                stride: int) -> torch.Tensor:
    """NCHW conv with TF 'SAME' padding: out = ceil(in / stride), and the
    odd pixel of padding goes to the bottom/right. torch's symmetric
    ``padding=1`` shifts the output by one pixel on even inputs."""
    kh, kw = weight.shape[2], weight.shape[3]
    top, bottom = same_pads(x.shape[2], kh, stride)
    left, right = same_pads(x.shape[3], kw, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, weight, bias, stride=stride)


def compute_dense_shape(config: dict) -> Tuple[int, int, int]:
    """floor(dim / 2^L) dense reshape, with the JAX core's collapse errors."""
    image_size = config["data"]["image_size"]
    image_width, image_height = image_size[0], image_size[1]
    layer_count = len(config["model"]["layers"])
    dense_width = int(float(image_width) / float(2**layer_count))
    dense_height = int(float(image_height) / float(2**layer_count))
    if dense_width == 0:
        raise RuntimeError(
            f"Error: Build Decoder: Width Collapse: Too many layers, check configuration file: "
            f"{image_width} -> {dense_width}: {layer_count} Layers"
        )
    if dense_height == 0:
        raise RuntimeError(
            f"Error: Build Decoder: Height Collapse: Too many layers, check configuration file: "
            f"{image_height} -> {dense_height}: {layer_count} Layers"
        )
    return dense_width, dense_height, int(config["model"]["decoder_dense_filters"])


def _conv_out(n: int, layers: int) -> int:
    for _ in range(layers):
        n = -(-n // 2)
    return n


class Encoder(nn.Module):
    """Conv encoder producing the concatenated (mean, logvar) vector."""

    def __init__(self, input_shape: Sequence[int], conv_filters: Sequence[int],
                 latent_size: int, encoder_dense_filters: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        h, w, c = (int(v) for v in input_shape)
        kw = dict(dtype=param_dtype, device=device)
        self.layers = nn.ModuleDict()
        for i, f in enumerate(conv_filters):
            self.layers[f"Conv_{i}"] = nn.Conv2d(c, int(f), 3, stride=2, **kw)
            c = int(f)
        self.n_conv = len(conv_filters)
        flat = _conv_out(h, self.n_conv) * _conv_out(w, self.n_conv) * c
        self.n_dense = 0
        if encoder_dense_filters:
            self.layers["Dense_0"] = nn.Linear(flat, int(encoder_dense_filters), **kw)
            flat = int(encoder_dense_filters)
            self.n_dense = 1
        self.layers[f"Dense_{self.n_dense}"] = nn.Linear(flat, 2 * latent_size, **kw)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.to(self.dtype).permute(0, 3, 1, 2)
        for i in range(self.n_conv):
            conv = self.layers[f"Conv_{i}"]
            x = F.relu(conv2d_same(x, conv.weight.to(self.dtype),
                                   conv.bias.to(self.dtype), 2))
        # row-major HWC flatten, as the JAX encoder (Keras Flatten) does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for j in range(self.n_dense + 1):
            dense = self.layers[f"Dense_{j}"]
            x = F.linear(x, dense.weight.to(self.dtype), dense.bias.to(self.dtype))
        return x.to(torch.float32)


class Decoder(nn.Module):
    """Transposed-conv decoder producing reconstruction logits."""

    def __init__(self, conv_filters: Sequence[int], dense_shape: Tuple[int, int, int],
                 latent_size: int, output_channels: int,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.dense_shape = tuple(int(v) for v in dense_shape)
        dw, dh, df = self.dense_shape
        kw = dict(dtype=param_dtype, device=device)
        self.layers = nn.ModuleDict()
        self.layers["Dense_0"] = nn.Linear(latent_size, dw * dh * df, **kw)
        filters = [int(f) for f in reversed(list(conv_filters))]
        self.strides = [2] * len(filters) + [1]
        c = df
        for i, f in enumerate(filters + [int(output_channels)]):
            # ConvTranspose2d weight layout: (in, out, kh, kw)
            self.layers[f"ConvTranspose_{i}"] = nn.ConvTranspose2d(c, f, 3, **kw)
            c = f

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dw, dh, df = self.dense_shape
        dense = self.layers["Dense_0"]
        x = F.relu(F.linear(z.to(self.dtype), dense.weight.to(self.dtype),
                            dense.bias.to(self.dtype)))
        x = x.reshape(x.shape[0], dw, dh, df).permute(0, 3, 1, 2)  # HWC -> NCHW
        last = len(self.strides) - 1
        for i, s in enumerate(self.strides):
            convt = self.layers[f"ConvTranspose_{i}"]
            x = conv_transpose_same(x, convt.weight.to(self.dtype), s)
            x = x + convt.bias.to(self.dtype)[None, :, None, None]
            if i < last:
                x = F.relu(x)
        # contiguous NHWC, whatever memory format the conv backend chose
        return x.permute(0, 2, 3, 1).to(torch.float32).contiguous()


def _glorot_(t: torch.Tensor, fan_in: int, fan_out: int, gen: torch.Generator) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=gen)


class AbstractCVAE(nn.Module):
    """The CVAE: hyperparameters from the config plus encoder and decoder.

    Unlike the JAX core, this module owns its parameters (``state_dict()``);
    ``ops/quant.serving_forward`` wraps its eval forward in the
    ``forward(params, x)`` signature the engines call.
    """

    def __init__(self, config: dict, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.beta = float(cfg["training"]["beta"])
        self.encoder_input_shape = tuple(int(v) for v in cfg["data"]["image_size"])
        self.latent_size = int(cfg["model"]["latent_dimensions"])
        self.conv_filters = tuple(int(f) for f in cfg["model"]["layers"])
        edf = cfg["model"].get("encoder_dense_filters")
        self.encoder_dense_filters = int(edf) if edf else None
        self.dense_shape = compute_dense_shape(cfg)
        self.encoder = Encoder(self.encoder_input_shape, self.conv_filters,
                               self.latent_size, self.encoder_dense_filters,
                               dtype=dtype, param_dtype=param_dtype, device=device)
        self.decoder = Decoder(self.conv_filters, self.dense_shape, self.latent_size,
                               self.encoder_input_shape[2],
                               dtype=dtype, param_dtype=param_dtype, device=device)

    # -- parameter initialization -------------------------------------------------
    def init_params(self, seed: int = 0) -> None:
        """Glorot-uniform kernels and zero biases, drawn on the parameters'
        own device from a seeded generator (the flagship's 5.4 GB of f32
        weights are never built on the host). The draws differ from
        ``jax.random``'s; tests carry weights over with ``bridge.py``."""
        device = next(self.parameters()).device
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        for name, mod in list(self.encoder.layers.items()) + list(self.decoder.layers.items()):
            w = mod.weight
            if isinstance(mod, nn.Linear):
                fan_in, fan_out = w.shape[1], w.shape[0]
            else:  # Conv2d (out, in, kh, kw) or ConvTranspose2d (in, out, kh, kw)
                rf = w.shape[2] * w.shape[3]
                fan_in, fan_out = rf * w.shape[1], rf * w.shape[0]
            _glorot_(w, fan_in, fan_out, gen)
            with torch.no_grad():
                mod.bias.zero_()

    # -- forward pieces -----------------------------------------------------------
    def encode(self, x: torch.Tensor, training: bool = False,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               beta: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Split the encoder output into (mean, logvar). With ``training``
        the input is fuzzed by ``beta * noise`` (noise ~ N(0, 1), injected
        or drawn from ``generator``)."""
        x = normalize_image_input(x)
        if training:
            if noise is None:
                noise = torch.randn(x.shape, generator=generator, device=x.device)
            x = x + (self.beta if beta is None else beta) * noise
        out = self.encoder(x)
        mean, logvar = torch.chunk(out, 2, dim=1)
        return mean, logvar

    def reparameterize(self, mean: torch.Tensor, logvar: torch.Tensor,
                       training: bool = False, eps: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z = mean + 0.5*logvar + eps (eps injected, drawn when training,
        zeros otherwise)."""
        if eps is None:
            if training:
                eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                                  dtype=mean.dtype)
            else:
                eps = torch.zeros_like(mean)
        return mean + (logvar * 0.5) + eps

    def decode(self, z: torch.Tensor, apply_sigmoid: bool = False) -> torch.Tensor:
        logits = self.decoder(z)
        if apply_sigmoid:
            return torch.sigmoid(logits)
        return logits

    def sample(self, eps: Optional[torch.Tensor] = None, n: int = 100,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Decode n ~ N(0, 1) latents with sigmoid."""
        if eps is None:
            device = next(self.parameters()).device
            eps = torch.randn((n, self.latent_size), generator=generator, device=device)
        return self.decode(eps, apply_sigmoid=True)

    def call_detailed(self, x: torch.Tensor, training: bool = False,
                      eps: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
        """(x_prob, z, mean, logvar); ``training`` gates only the latent eps."""
        mean, logvar = self.encode(x)
        z = self.reparameterize(mean, logvar, training=training, eps=eps, generator=generator)
        x_prob = self.decode(z, apply_sigmoid=True)
        return x_prob, z, mean, logvar

    def call(self, x: torch.Tensor, training: bool = False,
             eps: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mean, logvar = self.encode(x)
        z = self.reparameterize(mean, logvar, training=training, eps=eps, generator=generator)
        return self.decode(z, apply_sigmoid=True)

    forward = call

    def compute_loss(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} has no loss: the model types of registry.py "
            "(KurtosisGlobal, KurtosisSingle, KLGaussian) define compute_loss")
