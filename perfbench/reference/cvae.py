"""The plain reference of the Kurtosis-CVAE: forward, KurtosisGlobal loss, and Adam.

Written from the model's description (the reference repository's Keras model, and the
semantics that the JAX package and its port keep), in plain PyTorch and float32, with
no kernel, cache or batching of the program. It imports nothing of the program and
takes nothing the program made: the benchmark makes the weights and the inputs from
the seed and hands the same to both.

  * Encoder: TF-SAME 3x3 stride-2 convolutions with relu (the odd pixel of padding at
    the bottom and right), a row-major HWC flatten, an optional Dense, then
    Dense(2 * latent) split into (mean, logvar).
  * z = mean + 0.5 * logvar + eps (the description's form, not exp(0.5 logvar) * eps).
  * Decoder: Dense with relu, reshaped to (H / 2^L, W / 2^L, filters) in HWC order,
    TF-SAME 3x3 stride-2 transposed convolutions with relu (the first 2n rows and
    columns of the full output), a stride-1 transposed convolution, sigmoid.
  * KurtosisGlobal loss: w_mse * mean((x - x_hat)^2) + w_kurtosis * |k - kurt(z)| +
    w_skew * |skew(z)| + w_z_l1 * mean|z|, the moments of the whole z, population
    variance, z-scores 0 where the standard deviation is 0. Its gradient is autograd's.
  * Adam as optax's ``adam`` with injected float32 hyperparameters: b1, b2 rounded to
    float32, eps outside the root, bias corrections b^t in float32.

The parameters are a dict in torch's module layout (Conv2d (out, in, kh, kw),
ConvTranspose2d (in, out, kh, kw), Linear (out, in)) under the names
``param_spec`` gives.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    fan_in: int
    fan_out: int


def _halve(n: int, times: int) -> int:
    for _ in range(times):
        n = -(-n // 2)
    return n


def dense_shape(config: dict) -> Tuple[int, int, int]:
    """(H / 2^L, W / 2^L, decoder filters), floored: the decoder's first feature map."""
    h, w, _ = (int(v) for v in config["data"]["image_size"])
    layers = len(config["model"]["layers"])
    return int(h / 2 ** layers), int(w / 2 ** layers), int(config["model"]["decoder_dense_filters"])


def param_spec(config: dict) -> List[Leaf]:
    """Every parameter of the model, in a fixed order, with its Glorot fans."""
    h, w, c = (int(v) for v in config["data"]["image_size"])
    model = config["model"]
    filters = [int(f) for f in model["layers"]]
    latent = int(model["latent_dimensions"])
    edf = model.get("encoder_dense_filters")
    leaves: List[Leaf] = []

    def conv(prefix, cin, cout, transpose):
        shape = (cin, cout, 3, 3) if transpose else (cout, cin, 3, 3)
        leaves.append(Leaf(prefix + ".weight", shape, 9 * cin, 9 * cout))
        leaves.append(Leaf(prefix + ".bias", (cout,), cin, cout))

    def linear(prefix, fin, fout):
        leaves.append(Leaf(prefix + ".weight", (fout, fin), fin, fout))
        leaves.append(Leaf(prefix + ".bias", (fout,), fin, fout))

    cin = c
    for i, f in enumerate(filters):
        conv(f"encoder.layers.Conv_{i}", cin, f, False)
        cin = f
    flat = _halve(h, len(filters)) * _halve(w, len(filters)) * cin
    n_dense = 0
    if edf:
        linear("encoder.layers.Dense_0", flat, int(edf))
        flat, n_dense = int(edf), 1
    linear(f"encoder.layers.Dense_{n_dense}", flat, 2 * latent)
    dh, dw, ddf = dense_shape(config)
    linear("decoder.layers.Dense_0", latent, dh * dw * ddf)
    cin = ddf
    for i, f in enumerate(list(reversed(filters)) + [c]):
        conv(f"decoder.layers.ConvTranspose_{i}", cin, f, True)
        cin = f
    return leaves


@contextmanager
def tf32(enabled: bool):
    """Products in TF32 (the control's precision) or in float32 (the reference's)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(enabled)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _same_pads(n: int, stride: int, k: int = 3) -> Tuple[int, int]:
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


#: the model types whose forward and loss this reference writes out
MODEL_TYPES = ("KurtosisGlobal",)


def forward(params: Params, config: dict, x: torch.Tensor, eps: torch.Tensor):
    """(x_hat in [0, 1] NHWC, z, mean, logvar) of frames x: uint8 pixels, or floats
    already in [0, 1]. Refuses a configuration of another model type."""
    if config["model"]["type"] not in MODEL_TYPES:
        raise ValueError(f"the reference writes out {MODEL_TYPES}, not model type "
                         f"{config['model']['type']!r}")
    x = x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x.to(torch.float32)
    filters = [int(f) for f in config["model"]["layers"]]
    y = x.permute(0, 3, 1, 2)
    for i in range(len(filters)):
        top, bottom = _same_pads(y.shape[2], 2)
        left, right = _same_pads(y.shape[3], 2)
        p = f"encoder.layers.Conv_{i}"
        y = F.relu(F.conv2d(F.pad(y, (left, right, top, bottom)), params[p + ".weight"],
                            params[p + ".bias"], stride=2))
    y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)
    j = 0
    while f"encoder.layers.Dense_{j}.weight" in params:
        p = f"encoder.layers.Dense_{j}"
        y = F.linear(y, params[p + ".weight"], params[p + ".bias"])
        j += 1
    latent = int(config["model"]["latent_dimensions"])
    mean, logvar = y[:, :latent], y[:, latent:]
    z = mean + 0.5 * logvar + eps
    dh, dw, ddf = dense_shape(config)
    d = F.relu(F.linear(z, params["decoder.layers.Dense_0.weight"],
                        params["decoder.layers.Dense_0.bias"]))
    d = d.reshape(-1, dh, dw, ddf).permute(0, 3, 1, 2)
    last = len(filters)
    for i in range(last + 1):
        p = f"decoder.layers.ConvTranspose_{i}"
        n_h, n_w = d.shape[2], d.shape[3]
        if i < last:  # stride 2: the first 2n rows and columns of the full output
            d = F.conv_transpose2d(d, params[p + ".weight"], stride=2)[:, :, :2 * n_h, :2 * n_w]
        else:  # stride 1, padding 1: the same size
            d = F.conv_transpose2d(d, params[p + ".weight"], stride=1, padding=1)
        d = d + params[p + ".bias"][None, :, None, None]
        if i < last:
            d = F.relu(d)
    x_hat = torch.sigmoid(d).permute(0, 2, 3, 1)
    return x_hat, z, mean, logvar


def global_moments(z: torch.Tensor):
    """Mean, population variance, skew and kurtosis of all of z."""
    n = z.numel()
    m = z.sum() / n
    zc = z - m
    std = torch.sqrt((zc * zc).sum() / n)
    zs = torch.where(std == 0, torch.zeros_like(zc), zc / torch.where(std == 0, 1.0, std))
    return m, std * std, (zs ** 3).sum() / n, (zs ** 4).sum() / n


def kurtosis_global_loss(params: Params, config: dict, x_u8: torch.Tensor,
                         eps: torch.Tensor) -> torch.Tensor:
    loss_cfg = config["loss"]
    x = x_u8.to(torch.float32) / 255.0
    x_hat, z, _mean, _logvar = forward(params, config, x, eps)
    _m, _var, skew, kurt = global_moments(z)
    return (float(loss_cfg["w_mse"]) * ((x - x_hat) ** 2).mean()
            + float(loss_cfg["w_kurtosis"]) * torch.abs(float(loss_cfg["kurtosis"]) - kurt)
            + float(loss_cfg["w_skew"]) * torch.abs(skew)
            + float(loss_cfg["w_z_l1_reg"]) * z.abs().mean())


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


#: optax's adam decays as float32, and 1 - b1 taken in float32 (mu's first step is
#: (1 - b1) g, so a gradient is mu / ONE_MINUS_B1 after one step)
B1, B2, ADAM_EPS = _f32(0.9), _f32(0.999), 1e-8
ONE_MINUS_B1 = float(torch.tensor(1.0) - torch.tensor(0.9))
ONE_MINUS_B2 = float(torch.tensor(1.0) - torch.tensor(0.999))


class TrainSteps(NamedTuple):
    losses: List[float]
    first_grad_norms: Dict[str, float]


def train_steps(params: Params, config: dict, batches: Sequence[torch.Tensor],
                eps: Sequence[torch.Tensor]) -> TrainSteps:
    """Adam steps of the KurtosisGlobal loss, one a batch, on ``params`` in place
    (leaves that require grad). Returns each step's loss and the norm of each leaf's
    first gradient."""
    names = list(params)
    leaves = [params[k] for k in names]
    lr = _f32(float(config["training"]["learning_rate"]))
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    losses, first = [], {}
    for t, (x, e) in enumerate(zip(batches, eps), start=1):
        loss = kurtosis_global_loss(params, config, x, e)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if t == 1:
            first = {k: float(torch.linalg.vector_norm(g)) for k, g in zip(names, grads)}
        c1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** t
        c2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** t
        with torch.no_grad():
            for p, g, m, v in zip(leaves, grads, mu, nu):
                m.mul_(B1).add_(g * ONE_MINUS_B1)
                v.mul_(B2).add_(g * g * ONE_MINUS_B2)
                p.add_(-lr * (m / float(c1)) / (torch.sqrt(v / float(c2)) + ADAM_EPS))
        del grads
    return TrainSteps(losses, first)


def glorot_limit(leaf: Leaf) -> float:
    return math.sqrt(6.0 / (leaf.fan_in + leaf.fan_out))
