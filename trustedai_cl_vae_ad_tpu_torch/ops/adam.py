"""Adam for the port: ``adam`` (moments in the parameters' dtype) and
``adam_lean`` (moments stored narrow, nu's EMA in float32).

Counterpart of ``make_optimizer`` in ``trustedai_cl_vae_ad_tpu/models/
wrapper.py`` and of ``trustedai_cl_vae_ad_tpu/ops/adam.py``. The JAX package
builds both from optax and XLA, not from a Pallas kernel, so this is plain
tensor code. The arithmetic follows optax's
``scale_by_adam`` step by step, in optax's dtype at each step:

  mu  = (1 - b1) * g + b1 * mu                       (in the gradient's dtype)
  nu  = (1 - b2) * g**2 + b2 * nu                    (adam: gradient's dtype;
                                                      adam_lean: g**2 in the
                                                      gradient's dtype, the
                                                      EMA in float32)
  mu_hat = mu / (1 - b1**t),  nu_hat = nu / (1 - b2**t)
  update = mu_hat / (sqrt(nu_hat) + eps)             (eps outside the root)
  param += -lr * update                              (lr rounded to the
                                                      gradient's dtype, as
                                                      optax's injected
                                                      hyperparameters are)

With bfloat16 parameters ``adam`` runs nu's EMA in bfloat16, where the
b2 = 0.999 increments round away and nu freezes; ``adam_lean`` exists to
avoid that: it widens nu to float32 for the EMA and stores it back in
bfloat16, round-to-nearest or (``stochastic_round_nu``) with stochastic
rounding from an explicit ``torch.Generator``. Parameters are updated in
place. The learning rate is a plain attribute, changed at any time with no
rebuild.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


def stochastic_round_bf16(x32: torch.Tensor, generator: Optional[torch.Generator] = None,
                          region: Optional[Tuple[Tuple[int, ...], int, int]] = None
                          ) -> torch.Tensor:
    """float32 -> bfloat16 with stochastic rounding: add uniform random bits
    below the bfloat16 mantissa boundary, then truncate to the high 16 bits.
    Unbiased: a value between two bfloat16 neighbours rounds up with a
    probability equal to its distance from the lower one. ``region`` (full
    shape, dim, start): ``x32`` is the block of a larger tensor that starts
    there along that dim, and takes the bits the whole tensor's draw gives it
    (a ZeRO-1 shard, ``parallel/zero.py``)."""
    bits = x32.contiguous().view(torch.int32)
    shape = bits.shape if region is None else region[0]
    noise = torch.randint(0, 1 << 16, shape, dtype=torch.int32, device=bits.device,
                          generator=generator)
    if region is not None:
        noise = noise.narrow(region[1], region[2], bits.shape[region[1]])
    dithered = (bits + noise) & -65536  # wraps like uint32; keep the high half
    return dithered.view(torch.float32).to(torch.bfloat16)


class Adam:
    """Adam over a dict of named parameters (leaf tensors, updated in place).

    ``mu_dtype`` / ``nu_dtype`` None stores a moment in its parameter's
    dtype. ``widen_nu`` runs nu's EMA in float32 whatever its storage.
    ``float32_decays`` rounds b1 and b2 to float32 before 1 - b is taken.
    """

    def __init__(self, params: Dict[str, torch.Tensor], learning_rate: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: Optional[torch.dtype] = None,
                 nu_dtype: Optional[torch.dtype] = None, widen_nu: bool = False,
                 stochastic_round_nu: bool = False,
                 generator: Optional[torch.Generator] = None, name: str = "adam",
                 float32_decays: bool = False):
        self.name = name
        self.learning_rate = float(learning_rate)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        if float32_decays:
            # optax's injected b1, b2 are float32 arrays: 1 - b2 is then
            # float32(1) - float32(0.999), 1.3e-5 off 0.001
            self.b1, self.b2 = (float(torch.tensor(b, dtype=torch.float32)) for b in (b1, b2))
        self._omb1 = float(torch.tensor(1.0, dtype=torch.float32) - self.b1) \
            if float32_decays else 1.0 - self.b1
        self._omb2 = float(torch.tensor(1.0, dtype=torch.float32) - self.b2) \
            if float32_decays else 1.0 - self.b2
        self.widen_nu = bool(widen_nu)
        self.stochastic_round_nu = bool(stochastic_round_nu)
        self.generator = generator
        self.count = 0
        self.names: List[str] = list(params)
        self.params: List[torch.Tensor] = [params[k] for k in self.names]
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=nu_dtype or p.dtype) for p in self.params]
        #: per parameter, None or the ``stochastic_round_bf16`` region it is a block of
        self.regions: List[Optional[tuple]] = [None] * len(self.params)

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None) -> None:
        """One update from ``grads`` (default: each parameter's ``.grad``),
        tensor by tensor, so the temporaries of one tensor are freed before
        the next (the flagship's encoder Dense alone is 1.08 G values)."""
        if grads is None:
            grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            missing = [n for n, g in zip(self.names, grads) if g is None]
            raise ValueError(f"no gradient for {missing}")
        self.count += 1
        # optax computes decay**count in float32
        c1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** self.count
        c2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32) ** self.count
        for p, g, mu, nu, region in zip(self.params, grads, self.mu, self.nu, self.regions):
            self._update_one(p, g, mu, nu, c1, c2, region)

    def _update_one(self, p, g, mu, nu, c1, c2, region=None) -> None:
        b1, b2 = self.b1, self.b2
        # mu's EMA in the gradient's dtype (mu widens to it where it is wider)
        m = g * self._omb1
        m.add_(mu.to(m.dtype) * b1)
        # nu: (1 - b2) * g**2 in the gradient's dtype, then the EMA
        v = (g * g).mul_(self._omb2)
        if self.widen_nu:
            v = v.to(torch.float32)
        v.add_(nu.to(v.dtype) * b2)
        # each bias correction is cast to its moment's dtype, then divides
        mu_hat = m / float(c1.to(m.dtype))
        denom = (v / float(c2.to(v.dtype))).sqrt_().add_(self.eps)
        update = mu_hat.div_(denom) if mu_hat.dtype == denom.dtype else mu_hat / denom
        del denom
        # optax keeps the injected learning rate in the gradient's dtype
        update.mul_(-float(torch.tensor(self.learning_rate, dtype=g.dtype)))
        if update.dtype == p.dtype:
            p.add_(update)
        else:  # p + u in the wider dtype, rounded once into p's
            p.copy_(update.add_(p))
        del update
        mu.copy_(m)
        if self.stochastic_round_nu and nu.dtype == torch.bfloat16 and v.dtype == torch.float32:
            nu.copy_(stochastic_round_bf16(v, self.generator, region))
        else:
            nu.copy_(v)

    # -- state in and out ---------------------------------------------------------
    def state_dict(self) -> dict:
        """{'count': int, 'learning_rate': float, 'mu': {name: tensor}, 'nu':
        {name: tensor}} (the tensors are the live moments, not copies). The
        learning rate is part of the state, as optax's injected
        hyperparameter is in the JAX package: a rate dialled at run time
        survives a save and a resume."""
        return {"count": int(self.count), "learning_rate": float(self.learning_rate),
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def full_moment(self, kind: str, name: str) -> torch.Tensor:
        """One moment ('mu' or 'nu') of one parameter in the full layout: the
        live tensor (``parallel.zero.Zero1`` gathers its blocks)."""
        return getattr(self, kind)[self.names.index(name)]

    def load_state_dict(self, state: dict) -> None:
        """Restore the moments, the step count and, where the state holds
        one, the learning rate. A state without it (the port's checkpoints
        written before the rate was saved) keeps the rate this optimizer was
        made with: it has nothing to restore."""
        for kind, dst in (("mu", self.mu), ("nu", self.nu)):
            src = state[kind]
            if set(src) != set(self.names):
                raise KeyError(f"optimizer state '{kind}' names differ from the parameters': "
                               f"{sorted(set(src) ^ set(self.names))}")
            with torch.no_grad():
                for name, t in zip(self.names, dst):
                    if tuple(src[name].shape) != tuple(t.shape):
                        raise ValueError(f"optimizer state {kind}/{name} has shape "
                                         f"{tuple(src[name].shape)}, expected {tuple(t.shape)}")
                    t.copy_(src[name])
        self.count = int(state["count"])
        if state.get("learning_rate") is not None:
            self.learning_rate = float(state["learning_rate"])


def optimizer_name(name: Optional[str], param_dtype: torch.dtype = torch.float32) -> str:
    """The variant ``make_optimizer`` builds for ``training.optimizer`` ``name``."""
    if name is None:
        return "adam_lean" if param_dtype == torch.bfloat16 else "adam"
    return name


def make_optimizer(params: Dict[str, torch.Tensor], learning_rate: float,
                   param_dtype: torch.dtype = torch.float32, name: Optional[str] = None,
                   stochastic_round_nu: bool = False,
                   generator: Optional[torch.Generator] = None, regions: Optional[dict] = None):
    """Adam with a runtime-mutable learning rate.

    ``name`` (config key ``training.optimizer``) selects the variant:
      * ``adam`` — moments and arithmetic in the parameters' dtype (the
        float32-parameter default);
      * ``adam_lean`` — bfloat16 moment storage, float32 arithmetic for nu's
        EMA (the bfloat16-parameter default);
      * ``adam_fp8`` — float8_e4m3 moment storage with lagged per-row
        scales (``ops/adam8.py::AdamFp8``, the same surface as ``Adam``).

    ``regions`` ({name: ``ops.adam8.Region``}) marks parameters that are
    blocks of larger tensors, for ``adam_fp8`` (the Adam variants take
    theirs through ``Adam.regions``).
    """
    name = optimizer_name(name, param_dtype)
    if name == "adam_fp8":
        from trustedai_cl_vae_ad_tpu_torch.ops.adam8 import AdamFp8

        return AdamFp8(params, learning_rate, regions=regions)
    if regions:
        raise ValueError(f"regions are adam_fp8's; {name} takes Adam.regions")
    if name == "adam_lean":
        return Adam(params, learning_rate, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16,
                    widen_nu=True, stochastic_round_nu=stochastic_round_nu,
                    generator=generator, name=name)
    if name != "adam":
        raise ValueError(f"unknown training.optimizer {name!r} "
                         "(expected adam | adam_lean | adam_fp8)")
    # optax.adam under inject_hyperparams keeps b1 and b2 in the parameters'
    # dtype; float32 is followed. In bfloat16 b2 would round to 1 and the
    # update would be NaN, which is not followed.
    return Adam(params, learning_rate, name=name, float32_decays=True)
