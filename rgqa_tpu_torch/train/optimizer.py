"""BertAdam, its schedules and the other ``--optim`` choices (port of
``rgqa_tpu/train/optimizer.py``).

The reference optimizer of every RGQA fine-tune
(``src/lxrt/optimization.py:52-180``), as a ``torch.optim.Optimizer``:

- Adam moments with **no bias correction**;
- decoupled weight decay added to the update *after* the moment ratio,
  to every parameter;
- the schedule factor from the **pre-increment** step count, so the
  first step runs at lr 0 under warmup;
- no per-parameter clipping: the global clip-by-norm 5.0 lives in the
  train step.

The schedule arithmetic runs in float32 on the host, as the JAX package
runs it on the device, so the two learning rates agree bit for bit.  The
moment and parameter updates use ``torch._foreach`` ops: a few launches
per step for all parameters rather than a few per parameter.
``--bf16_moments`` keeps BertAdam's moments in bf16 and does their
arithmetic in f32, a cast in and a cast out, as the JAX package does.

The other ``--optim`` choices follow the JAX package's optax definitions
(``make_optimizer``), not ``torch.optim``'s defaults: ``adamax`` and
``sgd`` are the ``torch.optim`` classes at optax's hyper-parameters,
where the two agree; ``adam`` / ``adamw`` (weight decay 0, the same
update) are :class:`OptaxAdam` and ``rms`` :class:`OptaxRMSprop`,
written out, because ``torch.optim.Adam`` computes its bias corrections
in float64 (optax's are f32 and move the first steps by ~1e-5 relative)
and ``torch.optim.RMSprop`` decays by 0.99 with eps outside the square
root.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rgqa_tpu_torch.config import OptimConfig

__all__ = ["warmup_linear", "warmup_constant", "warmup_cosine", "BertAdam", "OptaxAdam",
           "OptaxRMSprop", "make_optimizer"]


def _f32(x) -> np.float32:
    return np.float32(x)


def warmup_linear(x, warmup: float = 0.002) -> np.float32:
    """Triangular schedule factor (``optimization.py:38-43``)."""
    x = _f32(x)
    if x < _f32(warmup):
        return x / _f32(warmup) if warmup > 0 else _f32(1.0)
    return max((x - _f32(1.0)) / _f32(warmup - 1.0), _f32(0.0))


def warmup_constant(x, warmup: float = 0.002) -> np.float32:
    """Warmup then constant (``optimization.py:31-36``)."""
    x = _f32(x)
    if x < _f32(warmup):
        return x / _f32(warmup) if warmup > 0 else _f32(1.0)
    return _f32(1.0)


def warmup_cosine(x, warmup: float = 0.002) -> np.float32:
    """Warmup then cosine over the whole run (``optimization.py:26-29``)."""
    x = _f32(x)
    if x < _f32(warmup):
        return x / _f32(warmup) if warmup > 0 else _f32(1.0)
    return _f32(0.5) * (_f32(1.0) + np.cos(_f32(math.pi) * x))


SCHEDULES = {
    "warmup_linear": warmup_linear,
    "warmup_constant": warmup_constant,
    "warmup_cosine": warmup_cosine,
}


class BertAdam(torch.optim.Optimizer):
    """The reference BertAdam.  Each parameter group keeps its step
    ``count`` (pre-increment, saved in ``state_dict``); each parameter
    its moments ``mu`` and ``nu``, in the parameter's dtype, or with
    ``bf16_moments`` in bf16: the moment updates and the step then read
    them in f32 and the new moments are stored rounded to bf16 (the JAX
    ``bert_adam(moment_dtype=jnp.bfloat16)``)."""

    def __init__(
        self,
        params,
        lr: float,
        *,
        warmup: float = -1.0,
        t_total: int = -1,
        schedule: str = "warmup_linear",
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-6,
        weight_decay: float = 0.01,
        bf16_moments: bool = False,
    ):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; have {sorted(SCHEDULES)}")
        defaults = dict(
            lr=lr, warmup=warmup, t_total=t_total, schedule=schedule, b1=b1, b2=b2,
            eps=eps, weight_decay=weight_decay, count=0, bf16_moments=bf16_moments,
        )
        super().__init__(params, defaults)

    @staticmethod
    def lr_at(group: dict) -> float:
        """The group's learning rate at its current count (f32 arithmetic)."""
        if group["t_total"] > 0:
            progress = _f32(group["count"]) / _f32(group["t_total"])
            return float(_f32(group["lr"]) * SCHEDULES[group["schedule"]](progress, group["warmup"]))
        return float(_f32(group["lr"]))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = group["params"]
            # A parameter the loss does not reach (no .grad) takes a zero
            # gradient, as in the JAX update: its moments decay and its
            # weight decay still applies.
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            bf16 = group.get("bf16_moments", False)
            for p in params:
                if not self.state[p]:
                    dtype = torch.bfloat16 if bf16 else p.dtype
                    self.state[p]["mu"] = torch.zeros_like(p, dtype=dtype)
                    self.state[p]["nu"] = torch.zeros_like(p, dtype=dtype)
            stored_mu = [self.state[p]["mu"] for p in params]
            stored_nu = [self.state[p]["nu"] for p in params]
            # bf16 moments: the arithmetic on f32 copies, stored back rounded.
            mus = [m.float() for m in stored_mu] if bf16 else stored_mu
            nus = [v.float() for v in stored_nu] if bf16 else stored_nu
            b1, b2 = group["b1"], group["b2"]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            if bf16:
                torch._foreach_copy_(stored_mu, mus)
                torch._foreach_copy_(stored_nu, nus)
                mus = [m.float() for m in stored_mu]
                nus = [v.float() for v in stored_nu]
            denom = torch._foreach_sqrt(nus)
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(mus, denom)
            if group["weight_decay"] > 0.0:
                torch._foreach_add_(updates, params, alpha=group["weight_decay"])
            torch._foreach_add_(params, updates, alpha=-self.lr_at(group))
            group["count"] += 1
        return loss


def _grads(params) -> list:
    """Each parameter's gradient; one the loss does not reach (no
    ``.grad``) takes a zero gradient, as in the JAX update."""
    return [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]


class OptaxAdam(torch.optim.Optimizer):
    """``optax.adam(lr)`` (the JAX package's ``--optim adam``, and
    ``adamw`` at weight decay 0): ``mu`` and ``nu`` as Adam's, the bias
    corrections ``1 - b**t`` in float32, as optax rounds them (the first
    step's ``1 - 0.999`` is 1.00005e-3 there; ``torch.optim.Adam``'s
    float64 corrections move the first updates by ~1e-5 relative), then
    ``p += -lr * mu_hat / (sqrt(nu_hat) + eps)`` with b1 0.9, b2 0.999,
    eps 1e-8.  Each parameter keeps ``mu``, ``nu`` and its step ``count``."""

    def __init__(self, params, lr: float, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = group["params"]
            grads = _grads(params)
            for p in params:
                if not self.state[p]:
                    self.state[p].update(mu=torch.zeros_like(p), nu=torch.zeros_like(p), count=0)
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            b1, b2 = group["b1"], group["b2"]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            count = self.state[params[0]]["count"] + 1
            for p in params:
                self.state[p]["count"] = count
            bc1 = float(_f32(1.0) - _f32(b1) ** np.int32(count))
            bc2 = float(_f32(1.0) - _f32(b2) ** np.int32(count))
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(mus, bc1)
            torch._foreach_div_(updates, denom)
            torch._foreach_mul_(updates, -group["lr"])
            torch._foreach_add_(params, updates)
        return loss


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr)`` (the JAX package's ``--optim rms``):
    ``nu = decay nu + (1 - decay) g^2``, then ``p -= lr g / sqrt(nu +
    eps)``, with decay 0.9 and eps 1e-8 inside the square root (optax's
    ``eps_in_sqrt=True``), ``nu`` starting at 0.  ``torch.optim.RMSprop``
    decays by 0.99 and adds eps outside the square root, so it takes
    other steps wherever ``nu`` is small; hence this class.  Each
    parameter keeps ``nu`` (in its dtype); a parameter without ``.grad``
    takes a zero gradient, as in the JAX update."""

    def __init__(self, params, lr: float, *, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = group["params"]
            grads = _grads(params)
            for p in params:
                if not self.state[p]:
                    self.state[p]["nu"] = torch.zeros_like(p)
            nus = [self.state[p]["nu"] for p in params]
            decay = group["decay"]
            torch._foreach_mul_(nus, decay)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - decay)
            denom = torch._foreach_add(nus, group["eps"])
            torch._foreach_sqrt_(denom)
            torch._foreach_addcdiv_(params, grads, denom, value=-group["lr"])
        return loss


def make_optimizer(cfg: OptimConfig, params, t_total: int = -1) -> torch.optim.Optimizer:
    """The optimizer of ``--optim`` (``src/param.py:11-30``, as the JAX
    package's ``make_optimizer`` maps it): ``bert`` (any name holding it)
    BertAdam with warmup over ``t_total`` steps, bf16 moments with
    ``--bf16_moments``; ``adam``, ``adamw`` (weight decay 0), ``adamax``
    and ``sgd`` at optax's defaults (b1 0.9, b2 0.999, eps 1e-8; no
    momentum), the first two as :class:`OptaxAdam`; ``rms``
    :class:`OptaxRMSprop`.  Any other name raises."""
    name = cfg.name.lower()
    if "bert" in name:
        return BertAdam(
            params, cfg.lr, warmup=cfg.warmup, t_total=t_total, schedule=cfg.schedule,
            weight_decay=cfg.weight_decay, bf16_moments=cfg.bf16_moments,
        )
    if name in ("adam", "adamw"):  # optax.adamw at weight decay 0 takes Adam's steps
        return OptaxAdam(params, cfg.lr)
    if name == "adamax":
        return torch.optim.Adamax(params, cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, cfg.lr)
    if name == "rms":
        return OptaxRMSprop(params, cfg.lr)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
