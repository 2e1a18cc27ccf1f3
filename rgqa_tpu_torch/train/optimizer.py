"""BertAdam and its schedules (port of ``rgqa_tpu/train/optimizer.py``).

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
per step for all parameters rather than a few per parameter.  bf16
moments (``--bf16_moments``) and the other optimizers are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rgqa_tpu_torch.config import OptimConfig

__all__ = ["warmup_linear", "warmup_constant", "warmup_cosine", "BertAdam", "make_optimizer"]


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
    its moments ``mu`` and ``nu``, in the parameter's dtype."""

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
    ):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; have {sorted(SCHEDULES)}")
        defaults = dict(
            lr=lr, warmup=warmup, t_total=t_total, schedule=schedule, b1=b1, b2=b2,
            eps=eps, weight_decay=weight_decay, count=0,
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
            for p in params:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            b1, b2 = group["b1"], group["b2"]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            denom = torch._foreach_sqrt(nus)
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(mus, denom)
            if group["weight_decay"] > 0.0:
                torch._foreach_add_(updates, params, alpha=group["weight_decay"])
            torch._foreach_add_(params, updates, alpha=-self.lr_at(group))
            group["count"] += 1
        return loss


def make_optimizer(cfg: OptimConfig, params, t_total: int = -1) -> BertAdam:
    """The optimizer of ``--optim`` (``src/param.py:11-30``): BertAdam
    with warmup over ``t_total`` steps.  The others raise."""
    if "bert" not in cfg.name.lower():
        raise NotImplementedError(f"--optim {cfg.name} is not ported yet; the port has bert")
    if cfg.bf16_moments:
        raise NotImplementedError("--bf16_moments is not ported yet")
    return BertAdam(
        params, cfg.lr, warmup=cfg.warmup, t_total=t_total, schedule=cfg.schedule,
        weight_decay=cfg.weight_decay,
    )
