"""Every input of a run, made from ``--seed`` on the device: the weights, the frames
and the latent noise. The program and the reference get the same ones.

Each kind of input draws from a ``torch.Generator`` of its own, seeded from the run's
seed and a fixed stream number, so that one kind can be made again alone: the
weights, leaf by leaf, for the reference after the program has trained its copy. A
seed is any whole number; it is folded into 63 bits.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.cvae import Leaf, glorot_limit, param_spec

_MASK = (1 << 63) - 1
FRAMES, LATENT, WEIGHTS = 1, 2, 1000
#: biases are drawn in +-this (the model's own init sets them to 0; the benchmark draws
#: them so that the comparison sees every leaf)
BIAS_LIMIT = 0.02


def sub_seed(seed: int, stream: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + int(stream) * 0xBF58476D1CE4E5B9 + 1) & _MASK


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def make_leaf(leaf: Leaf, index: int, seed: int, device, out: torch.Tensor = None):
    """Leaf ``index`` of ``param_spec``: Glorot-uniform weights, small uniform biases;
    drawn into ``out`` when given."""
    t = torch.empty(leaf.shape, dtype=torch.float32, device=device) if out is None else out
    if tuple(t.shape) != tuple(leaf.shape):
        raise ValueError(f"{leaf.name}: shape {tuple(t.shape)}, the model has {leaf.shape}")
    limit = BIAS_LIMIT if leaf.name.endswith(".bias") else glorot_limit(leaf)
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=generator(seed, WEIGHTS + index, device))
    return t


def fill_program_params(named: Iterable[Tuple[str, torch.Tensor]], config: dict,
                        seed: int) -> None:
    """Draw the weights into the program's own parameters, which must be exactly the
    leaves of ``param_spec`` (names and shapes)."""
    named = dict(named)
    spec = param_spec(config)
    if sorted(named) != sorted(leaf.name for leaf in spec):
        raise ValueError(f"the program's parameters {sorted(named)} are not the model's "
                         f"{sorted(leaf.name for leaf in spec)}")
    for i, leaf in enumerate(spec):
        make_leaf(leaf, i, seed, named[leaf.name].device, out=named[leaf.name].data)


def reference_params(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return {leaf.name: make_leaf(leaf, i, seed, device).requires_grad_(True)
            for i, leaf in enumerate(param_spec(config))}


def smooth_frames(g: torch.Generator, n: int, shape, grid, noise: float,
                  device) -> torch.Tensor:
    """n uint8 frames (n, H, W, C): a coarse random field, smoothly upsampled, plus
    pixel noise."""
    h, w, c = (int(v) for v in shape)
    field = torch.rand((n, c, int(grid[0]), int(grid[1])), generator=g, device=device)
    img = F.interpolate(field, size=(h, w), mode="bilinear", align_corners=False)
    img = img + float(noise) * torch.randn((n, c, h, w), generator=g, device=device)
    return torch.round(img.clamp(0.0, 1.0) * 255.0).to(torch.uint8).permute(0, 2, 3, 1) \
        .contiguous()


def train_epoch(seed: int, batches: int, batch: int, shape, grid, noise: float,
                device) -> torch.Tensor:
    """(batches, batch, H, W, C) uint8: one epoch of distinct frames, kept on the device."""
    g = generator(seed, FRAMES, device)
    return torch.stack([smooth_frames(g, batch, shape, grid, noise, device)
                        for _ in range(batches)])


def latent_noise(seed: int, n: int, batch: int, latent: int, device) -> torch.Tensor:
    """(n, batch, latent) float32 N(0, 1): the eps of each step."""
    return torch.randn((n, batch, latent), generator=generator(seed, LATENT, device),
                       device=device)


def camera_frames(seed: int, streams: int, frames: int, shape, grid, noise: float,
                  motion, device) -> np.ndarray:
    """(frames, streams, H, W, C) uint8 in host memory: each camera looks at a scene of
    its own that drifts by ``motion`` (rows, columns) pixels a frame, with fresh pixel
    noise in every frame. Made on the device, then copied to the host once."""
    h, w, c = (int(v) for v in shape)
    dy, dx = (int(v) for v in motion)
    g = generator(seed, FRAMES, device)
    canvas_hw = (h + dy * frames, w + dx * frames)
    field = torch.rand((streams, c, int(grid[0]), int(grid[1])), generator=g, device=device)
    canvas = F.interpolate(field, size=canvas_hw, mode="bilinear", align_corners=False)
    out = np.empty((frames, streams, h, w, c), np.uint8)
    for t in range(frames):
        img = canvas[:, :, t * dy:t * dy + h, t * dx:t * dx + w]
        img = img + float(noise) * torch.randn((streams, c, h, w), generator=g, device=device)
        u8 = torch.round(img.clamp(0.0, 1.0) * 255.0).to(torch.uint8).permute(0, 2, 3, 1)
        out[t] = u8.cpu().numpy()
    return out
