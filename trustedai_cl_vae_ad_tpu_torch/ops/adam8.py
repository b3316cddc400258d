"""Adam with float8 (e4m3) moment storage: ``training.optimizer: adam_fp8``.

Counterpart of ``trustedai_cl_vae_ad_tpu/ops/adam8.py`` (``adam_fp8`` under
``inject_hyperparams``, ``models/wrapper.py::make_optimizer``), with the same
state and the same bits. The JAX package builds it from XLA, not from a
Pallas kernel, so this is plain tensor code, on the CPU and the card alike.

Per parameter, in float32 whatever the storage, with the roundings of the
JAX package's compiled update on the CPU, which its tests run (XLA folds the
two divisions into one, and LLVM fuses the gradient's product of each EMA,
and a float32 parameter's update, into a multiply-add):

  mu = fma(g, 1 - b1, b1 * mu),   nu = fma((1 - b2) * g, g, b2 * nu)
  update = mu / ((1 - b1**t) * (sqrt(nu / (1 - b2**t)) + eps))
  param += -lr * update          (float32: fma(update, -lr, param); else the
                                  update cast to the gradient's dtype, then
                                  scaled by the rate in that dtype)

Storage. A big leaf (2-D or more, at least 2**20 elements) keeps each moment
as a ``QLeaf``: float8_e4m3fn bit patterns in an int8 tensor and two float32
scales, one a row of the JAX (flax) layout. It is quantized with the scale
of the step before (``scale_next``), and the fresh absmax/256 of this step's
value becomes the next step's; at init ``scale`` = 0 and ``scale_next`` = 1,
so the EMA starts one step late, as in JAX. Every other leaf is stored in
bfloat16. ``stochastic_round`` (``none`` | ``nu`` | ``both``) dithers the
narrow stores with bits of a counter-based hash of the element's index in
the flax layout, the step and the leaf's index in JAX's flattened tree.

Layouts. The port stores a Dense weight as (out, in) where flax has (in,
out), and permutes convolution kernels (``bridge.py``): flax's last axis is
the port's dim 0 in every layer. So a scale reduces over dim 0 here, with
shape (1, ...), and the hash takes each dim's flax axis
(``bridge.flax_leaf_layout``). A big leaf is updated in blocks of dim 0,
each a set of independent rows of the computation: the per-element
arithmetic and the index hash give the same bits in blocks, and the fresh
scale is a running maximum. The flagship's encoder Dense (1.075 G elements)
then needs ≈1 GB of temporaries, not ten float32 copies of itself.

Sharded leaves (``parallel/``). A parameter may be this rank's block of a
larger tensor, described by a ``Region``: the whole tensor's shape (which
decides whether the leaf is quantized), the block's offset along each dim
(the hash takes the element's index in the whole tensor) and, per split dim,
the process group holding the other blocks. ZeRO-1 splits flax's dim 0 (the
port's dim 1 of a Dense weight): a block holds whole flax rows, so its scales
are the slice of the full scales that it owns and need no collective. Tensor
parallelism splits the port's dim 0 (a Dense weight's output features, flax's
last axis): each block's row absmax is then a partial maximum, all-reduced
with MAX over the model group once per leaf and step before it becomes
``scale_next``. Either way the update keeps the replicated update's bits.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from trustedai_cl_vae_ad_tpu_torch.bridge import flax_leaf_layout

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
HEADROOM_TARGET = 256.0  # quantize so that the current absmax lands here (of 448)
BIG_LEAF_ELEMS = 1 << 20
BLOCK_ELEMS = 1 << 24  # elements of a big leaf updated at once (≈1 GB of temporaries)
_MASK32 = 0xFFFFFFFF
_DROP_BITS = {torch.bfloat16: 16, FP8: 20, torch.float16: 13}


class QLeaf(NamedTuple):
    """One quantized moment: ``q`` the float8_e4m3fn bit patterns as int8
    (the parameter's shape), ``scale`` the scale ``q`` was quantized with
    (dequant = q * scale), ``scale_next`` the fresh absmax/256 for the next
    step; both float32 of the parameter's shape with the dim of flax's last
    axis set to 1 (dim 0 for the port's layers)."""

    q: torch.Tensor
    scale: torch.Tensor
    scale_next: torch.Tensor


Moment = Union[torch.Tensor, QLeaf]


class Region(NamedTuple):
    """A parameter that is this rank's block of a larger tensor: ``shape``
    the whole tensor's, ``offsets`` where the block starts along each dim,
    ``groups`` {split dim: the process group whose ranks hold the blocks
    along it}."""

    shape: Tuple[int, ...]
    offsets: Tuple[int, ...]
    groups: Dict[int, object]


def last_axis_dim(name: str, ndim: int) -> int:
    """The dim of a parameter that is flax's last axis: a quantized moment's
    scales reduce over it (size 1 there)."""
    _, axes = flax_leaf_layout([name], {name: ndim})
    a = axes[name]
    return a.index(len(a) - 1) if a else 0


def map_moment(moment, name: str, dim: Optional[int], fn: Callable):
    """``fn(tensor, dim)`` over one moment in the state-dict layout of
    parameter ``name`` split along ``dim`` (None: not split): a tensor, or a
    quantized leaf's {'q', 'scale', 'scale_next'}. A scale is whole along
    the dim it reduces over (size 1, the same on every block), so ``fn``
    gets None there."""
    if not isinstance(moment, dict):
        return fn(moment, dim)
    row = last_axis_dim(name, moment["q"].dim())
    return {f: fn(t, None if f != "q" and dim == row else dim) for f, t in moment.items()}


def _is_big(shape: Sequence[int]) -> bool:
    n = 1
    for s in shape:
        n *= int(s)
    return len(shape) >= 2 and n >= BIG_LEAF_ELEMS


def _i32(v: int) -> int:
    """The int32 with the bits of the uint32 ``v`` (taken modulo 2**32)."""
    v &= _MASK32
    return v - (1 << 32) if v >= 1 << 31 else v


def _hash_bits(shape: Sequence[int], salt: int, axes: Optional[Sequence[int]] = None,
               start: Union[int, Sequence[int]] = 0, device=None) -> torch.Tensor:
    """The JAX package's dither bits, as int32 holding its uint32 bit
    patterns: a murmur3 finalizer over each element's index mixed with
    ``salt``. ``axes[j]`` is the flax axis of dim j (default: the same),
    ``start`` the offset of a block along dim 0, or its offsets along every
    dim. int32 multiplies and adds wrap modulo 2**32 as uint32 ones do;
    right shifts are masked to act as uint32 ones."""
    axes = tuple(range(len(shape))) if axes is None else tuple(axes)
    starts = ((start,) + (0,) * (len(shape) - 1)) if isinstance(start, int) else tuple(start)
    h = torch.zeros((), dtype=torch.int32, device=device)
    for j, n in enumerate(shape):
        first = starts[j]
        i = torch.arange(first, first + n, dtype=torch.int64, device=device)
        i = (i * ((0x9E3779B1 + 0x85EBCA77 * axes[j]) & _MASK32)) & _MASK32
        view = [1] * len(shape)
        view[j] = n
        h = h ^ torch.where(i >= 1 << 31, i - (1 << 32), i).to(torch.int32).view(view)
    h = h.expand(tuple(shape)).add(_i32((salt & _MASK32) * 0xC2B2AE3D))
    h ^= (h >> 16) & 0xFFFF
    h.mul_(_i32(0x85EBCA6B))
    h ^= (h >> 13) & 0x7FFFF
    h.mul_(_i32(0xC2B2AE35))
    h ^= (h >> 16) & 0xFFFF
    return h


def _sr_cast(x32: torch.Tensor, dtype: torch.dtype, noise: torch.Tensor) -> torch.Tensor:
    """float32 -> a narrow float with stochastic rounding: add dither bits
    below the target's mantissa, clear them, then convert (the truncated
    value is exact in the target for in-range normals)."""
    drop = _DROP_BITS[dtype]
    bits = x32.contiguous().view(torch.int32)
    dithered = bits + (noise & ((1 << drop) - 1))
    truncated = (dithered & -(1 << drop)).view(torch.float32)
    if dtype == FP8:
        # the dither can carry a value near 448 past it, and e4m3fn has no
        # inf: clamp in float32, where 448 is exact
        truncated = truncated.clamp(-FP8_MAX, FP8_MAX)
    return truncated.to(dtype)


def _rowabsmax(x32: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The absmax of each row along ``dim`` (flax's last axis)."""
    return x32.abs().amax(dim=dim, keepdim=True)


def _quantize(x32: torch.Tensor, scale: torch.Tensor, sr: bool,
              noise: Optional[torch.Tensor]) -> torch.Tensor:
    y = (x32 / scale).clamp(-FP8_MAX, FP8_MAX)  # e4m3fn has no inf: saturate
    q = _sr_cast(y, FP8, noise) if sr else y.to(FP8)
    return q.view(torch.int8)


def _fma(x, y, t: torch.Tensor) -> torch.Tensor:
    """x * y + t rounded once to float32 (a fused multiply-add): the product
    of two float32 values is exact in float64. ``x`` or ``y`` may be a
    Python float holding a float32 value."""
    xy = x.double() * y if isinstance(x, torch.Tensor) else y.double() * x
    return xy.add_(t.double()).float()


def dequant(leaf: Moment) -> torch.Tensor:
    """The float32 value of a moment, quantized or not."""
    if isinstance(leaf, QLeaf):
        return leaf.q.view(FP8).float() * leaf.scale
    return leaf.float()


class AdamFp8:
    """Adam with float8 moment storage over a dict of named parameters
    (updated in place). ``mu_dtype`` / ``nu_dtype``: ``torch.float8_e4m3fn``
    (big leaves quantized, the rest bfloat16), or a dtype for every leaf.
    Same surface as ``ops.adam.Adam``: ``step``, ``learning_rate``,
    ``state_dict``, ``load_state_dict``. Parameters named as the port's
    state dict (``encoder.layers.Dense_0.weight``) take the flax layout's
    leaf order and axes; other names are taken as flax leaves of their own
    layout, ordered by name. ``regions`` ({name: ``Region``}) marks the
    parameters that are blocks of larger tensors (``parallel/``)."""

    name = "adam_fp8"

    def __init__(self, params: Dict[str, torch.Tensor], learning_rate: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: torch.dtype = FP8, nu_dtype: torch.dtype = FP8,
                 stochastic_round: str = "both",
                 regions: Optional[Dict[str, Region]] = None):
        if stochastic_round not in ("none", "nu", "both"):
            raise ValueError(f"stochastic_round must be none | nu | both, not "
                             f"{stochastic_round!r}")
        self.learning_rate = float(learning_rate)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        # 1 - b as the float32 factors of the multiply-adds
        self._omb1, self._omb2 = (float(torch.tensor(1.0 - b, dtype=torch.float32))
                                  for b in (self.b1, self.b2))
        self.stochastic_round = stochastic_round
        self.dtypes = {"mu": mu_dtype, "nu": nu_dtype}
        self.count = 0
        self.names: List[str] = list(params)
        self.params: List[torch.Tensor] = [params[k] for k in self.names]
        index, axes = flax_leaf_layout(self.names, {k: p.dim() for k, p in params.items()})
        self.leaf_index = [index[k] for k in self.names]
        self.axes = [axes[k] for k in self.names]
        # the dim that flax's last axis is: scales reduce over it
        self.row_dim = [a.index(len(a) - 1) if a else 0 for a in self.axes]
        self.regions: List[Optional[Region]] = [(regions or {}).get(k) for k in self.names]
        self.mu = [self._zero(k, "mu") for k in range(len(self.names))]
        self.nu = [self._zero(k, "nu") for k in range(len(self.names))]

    def _zero(self, k: int, which: str) -> Moment:
        p, d = self.params[k], self.dtypes[which]
        whole = p.shape if self.regions[k] is None else self.regions[k].shape
        if d == FP8 and not _is_big(whole):
            d = torch.bfloat16
        if d != FP8:
            return torch.zeros(p.shape, dtype=d, device=p.device)
        sshape = list(p.shape)
        sshape[self.row_dim[k]] = 1
        # distinct buffers and values: q starts at 0, so scale's value is unused
        return QLeaf(q=torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                     scale=torch.zeros(sshape, dtype=torch.float32, device=p.device),
                     scale_next=torch.ones(sshape, dtype=torch.float32, device=p.device))

    def _sr_on(self, which: str, dtype: torch.dtype) -> bool:
        # only a narrow store is dithered: a float32 store of the float32 EMA is exact
        on = self.stochastic_round == "both" or (self.stochastic_round == "nu" and which == "nu")
        return on and dtype.itemsize < 4

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None) -> None:
        """One update from ``grads`` (default: each parameter's ``.grad``),
        parameter by parameter."""
        if grads is None:
            grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            missing = [n for n, g in zip(self.names, grads) if g is None]
            raise ValueError(f"no gradient for {missing}")
        count = self.count
        self.count += 1
        # the decays and bias corrections in float32, as JAX computes them
        c = torch.tensor(float(count + 1), dtype=torch.float32)
        c1 = float(1.0 - torch.tensor(self.b1, dtype=torch.float32) ** c)
        c2 = float(1.0 - torch.tensor(self.b2, dtype=torch.float32) ** c)
        for k, g in enumerate(grads):
            self._update_one(k, g, count, c1, torch.full((), c2, device=g.device))

    def _blocks(self, k: int) -> list:
        """Ellipsis (the whole tensor), or the slices of dim 0 that a big
        leaf is updated in."""
        p = self.params[k]
        if not any(isinstance(m[k], QLeaf) for m in (self.mu, self.nu)):
            return [...]
        rows = p.shape[0]
        step = max(1, BLOCK_ELEMS // max(1, p.numel() // rows))
        return [slice(r0, min(rows, r0 + step)) for r0 in range(0, rows, step)]

    def _rows(self, k: int, t: torch.Tensor, sl) -> torch.Tensor:
        """The part of a scale that a block of dim 0 uses."""
        return t if sl is Ellipsis or self.row_dim[k] == 0 else t[sl]

    def _starts(self, k: int, sl) -> Tuple[int, ...]:
        """The offsets in the whole tensor, one a dim, of a block of dim 0."""
        region = self.regions[k]
        starts = [0] * self.params[k].dim() if region is None else list(region.offsets)
        if sl is not Ellipsis:
            starts[0] += sl.start
        return tuple(starts)

    def _update_one(self, k: int, g: torch.Tensor, count: int, c1: float,
                    c2: torch.Tensor) -> None:
        p, moments = self.params[k], {"mu": self.mu[k], "nu": self.nu[k]}
        salt = count * 2 + self.leaf_index[k] * 7919
        # optax.scale(-lr) after the chain: the rate in the gradient's dtype
        lr = -float(torch.tensor(self.learning_rate, dtype=g.dtype))
        fresh = {w: torch.zeros_like(m.scale) for w, m in moments.items()
                 if isinstance(m, QLeaf)}
        for sl in self._blocks(k):
            g32 = g[sl].float()
            new = {"mu": _fma(g32, self._omb1, self._value(k, moments["mu"], sl) * self.b1),
                   "nu": _fma(self._omb2 * g32, g32,
                              self._value(k, moments["nu"], sl) * self.b2)}
            del g32
            # a float32 square root correctly rounded (the CPU's vectorized one is
            # not always): rounding float64's is exact for a square root. c2 is a
            # tensor on the device: CUDA divides by a Python scalar as a product
            # with its reciprocal, which is not always the quotient
            root = (new["nu"] / c2).double().sqrt_().float()
            update = new["mu"] / root.add_(self.eps).mul_(c1)
            del root
            target = p[sl]
            if g.dtype == p.dtype == torch.float32:
                # p + u * (-lr) is one multiply-add in the JAX package's update
                target.copy_(_fma(update, lr, target))
            else:
                update = update.to(g.dtype).mul_(lr)
                if update.dtype == p.dtype:
                    target.add_(update)
                else:  # p + u in the wider dtype, rounded once into p's
                    target.copy_(update.to(torch.promote_types(update.dtype, p.dtype))
                                 .add_(target))
            del update
            for which, x32 in new.items():
                self._store(k, which, moments[which], x32, sl, salt, fresh.get(which))
            del new
        group = None if self.regions[k] is None else self.regions[k].groups.get(self.row_dim[k])
        if fresh and group is not None:
            # split along the dim the scales reduce over: each block's absmax
            # is a partial maximum; one collective a leaf, both moments in it
            both = torch.stack(list(fresh.values()))
            dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
            fresh = dict(zip(fresh, both.unbind(0)))
        for which, f in fresh.items():
            leaf = moments[which]
            leaf.scale.copy_(leaf.scale_next)
            leaf.scale_next.copy_(f.div_(HEADROOM_TARGET).clamp_min_(1e-30))

    def _value(self, k: int, leaf: Moment, sl) -> torch.Tensor:
        if isinstance(leaf, QLeaf):
            return leaf.q[sl].view(FP8).float() * self._rows(k, leaf.scale, sl)
        return leaf[sl].float()

    def _store(self, k: int, which: str, leaf: Moment, x32: torch.Tensor, sl, salt: int,
               fresh: Optional[torch.Tensor]) -> None:
        """Write one block of a moment; for a quantized one also its rows'
        absmax into ``fresh``."""
        dtype = FP8 if isinstance(leaf, QLeaf) else leaf.dtype
        sr = self._sr_on(which, dtype)
        noise = _hash_bits(x32.shape, salt + (0 if which == "mu" else 1), self.axes[k],
                           self._starts(k, sl), x32.device) if sr else None
        if not isinstance(leaf, QLeaf):
            leaf[sl].copy_(_sr_cast(x32, dtype, noise) if sr else x32)
            return
        leaf.q[sl].copy_(_quantize(x32, self._rows(k, leaf.scale_next, sl), sr, noise))
        block_max = _rowabsmax(x32, self.row_dim[k])
        if self.row_dim[k] == 0:
            torch.maximum(fresh, block_max, out=fresh)
        else:
            self._rows(k, fresh, sl).copy_(block_max)

    # -- state in and out ---------------------------------------------------------
    def state_dict(self) -> dict:
        """{'count', 'learning_rate', 'mu': {name: tensor or {'q', 'scale',
        'scale_next'}}, 'nu': ...} (the live tensors, not copies)."""
        return {"count": int(self.count), "learning_rate": float(self.learning_rate),
                **{kind: {n: self.full_moment(kind, n) for n in self.names}
                   for kind in ("mu", "nu")}}

    def full_moment(self, kind: str, name: str):
        """One moment ('mu' or 'nu') of one parameter, live: a tensor, or
        {'q', 'scale', 'scale_next'} for a quantized leaf."""
        m = getattr(self, kind)[self.names.index(name)]
        return m._asdict() if isinstance(m, QLeaf) else m

    def load_state_dict(self, state: dict) -> None:
        """Restore the moments, the step count and, where the state holds
        one, the learning rate. Each entry must have this optimizer's storage
        for its parameter (a quantized leaf's three tensors, or one tensor),
        in the port's layout."""
        for kind, dst in (("mu", self.mu), ("nu", self.nu)):
            src = state[kind]
            if set(src) != set(self.names):
                raise KeyError(f"optimizer state '{kind}' names differ from the parameters': "
                               f"{sorted(set(src) ^ set(self.names))}")
            with torch.no_grad():
                for name, leaf in zip(self.names, dst):
                    got = src[name]
                    if isinstance(leaf, QLeaf) != isinstance(got, dict):
                        want = "a quantized leaf" if isinstance(leaf, QLeaf) else "one tensor"
                        raise ValueError(f"optimizer state {kind}/{name}: {want} expected")
                    pairs = ([(getattr(leaf, f), got[f]) for f in QLeaf._fields]
                             if isinstance(leaf, QLeaf) else [(leaf, got)])
                    for t, s in pairs:
                        if tuple(s.shape) != tuple(t.shape):
                            raise ValueError(f"optimizer state {kind}/{name} has shape "
                                             f"{tuple(s.shape)}, expected {tuple(t.shape)}")
                        t.copy_(s)
        self.count = int(state["count"])
        if state.get("learning_rate") is not None:
            self.learning_rate = float(state["learning_rate"])
