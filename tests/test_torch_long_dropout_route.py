"""The long backward's route without the bias gradient, emulated on the CPU.

#3L and 5L (``csrc/fused_attention_long_bwd.cu``) need each query row's
D = rowsum(dP P).  Taken exactly, it costs the dQ pass a sweep of the
keys of its own; algebraically it is rowsum(g o out), and the forward's
output is at hand.  From the bf16 output D moves dbias past its bound
(``test_torch_attention_long.py``), but no model path differentiates the
mask: there D enters only dS = P (dP - D), and the card's bf16 bound on
dq / dk / dv is 3e-2 + 1e-2 |plain| (``chip_smoke.TOL``).

These tests emulate that route in plain torch, with the card's roundings
(P dropped, rounded to bf16 and times V for the output, rounded to bf16;
D = rowsum(g o out) in f32; dS rounded to bf16 after the scale; P_drop
rounded to bf16 for dV), for the dropped output (5L, rate 0.1) and the
undropped one (#3L), at ViLT's widths (12 heads of 64, bf16 inputs),
batch 2: at UNITER's 76-token stream under its mask (questions of 4-40
tokens padded before the 36 image keys, a fully masked row) and at
ViLT-B/32's 165 / 185 and a 512 px image's 277 tokens under pad-patch
masks; each held to the plain pair's dq / dk / dv within the card's
bound.  The f32 passes take the same route: with P, the output and dS
in f32 and D from the f32 output, the emulation is held to the plain
pair's dq / dk / dv within the card's f32 bar, 1e-4 + 1e-4 |plain|, at
the same shapes, dropped and undropped (``_emulated`` and ``_inputs``
take the dtype).  And the plain pair's dq / dk / dv, through the
autograd Functions, do not depend on whether the bias asks for a
gradient; the wrapper refuses an ``out`` that does not go with its
``dbias``.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.ops import attention as att
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

HEADS, D = 12, 64
E = HEADS * D
RATE, SEED = 0.1, 0x5151_2525_7777
BOUND = (3e-2, 1e-2)  # the card's bf16 bound on dq, dk, dv (atol, rtol)
F32_BOUND = (1e-4, 1e-4)  # the card's f32 bar on the model route's dq, dk, dv
SHAPES = [76, 165, 185, 277]


def _inputs(s: int, seed: int, b: int = 2, dtype=torch.bfloat16):
    """q, k, v, g (B, s, 768) from numpy in ``dtype``, and the f32 (B, s) -10000
    mask: UNITER's at 76 tokens (40 text keys, questions of 4-40 tokens,
    36 image keys kept), ViLT's pad patches beyond; row 1 fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, s, E), dtype=np.float32)).to(dtype)
                  for _ in range(4))
    keys = np.arange(s)[None, :]
    if s == 76:
        text = 40
        masked = (keys < text) & (keys >= rng.integers(4, text + 1, (b, 1)))
    else:
        text = min(40, s // 3)
        pad = rng.integers(0, (s - text) // 4 + 1, (b, 1))
        masked = ((keys >= rng.integers(1, text + 1, (b, 1))) & (keys < text)) | (keys >= s - pad)
    masked[1] = True
    return q, k, v, g, torch.from_numpy(masked.astype(np.float32) * -10000.0)


def _heads(t):
    return t.float().reshape(t.shape[0], t.shape[1], HEADS, D).transpose(1, 2)


def _emulated(q, k, v, bias, g, rate: float):
    """dq, dk, dv as the passes of q's dtype compute them without the bias
    gradient: D from the forward's output, as the card makes it (bf16: P
    dropped, rounded and times V, the output rounded, dS and P_drop
    rounded before their products; f32: every step in f32)."""
    def rnd(t):
        return t.to(q.dtype).float()

    qh, kh, vh, gh = (_heads(t) for t in (q, k, v, g))
    scale = 1.0 / math.sqrt(D)
    p = torch.softmax(qh @ kh.transpose(-1, -2) * scale + bias[:, None, None, :], dim=-1)
    keep = att.dropout_keep_mask_ref(SEED, q.shape[0], HEADS, q.shape[1], k.shape[1], rate)
    t, _ = att.keep_threshold(rate)
    keep_scale = 256.0 / (256 - t)
    p_drop = torch.where(keep, p * keep_scale, 0.0)
    out = rnd(rnd(p_drop) @ vh)  # the forward's output
    d_out = (gh * out).sum(-1, keepdim=True)
    dp = torch.where(keep, (gh @ vh.transpose(-1, -2)) * keep_scale, 0.0)
    ds = rnd(p * (dp - d_out) * scale)
    dq, dk = ds @ kh, ds.transpose(-1, -2) @ qh
    dv = rnd(p_drop).transpose(-1, -2) @ gh
    return tuple(x.transpose(1, 2).reshape(q.shape[0], -1, E) for x in (dq, dk, dv))


def _route_errors(s: int, rate: float, dtype, bound):
    """Max |emulated - plain| of dq, dk, dv at ``s`` tokens, each asserted
    finite and within ``bound`` (atol, rtol) of the plain pair's."""
    q, k, v, g, bias = _inputs(s, seed=s + int(rate * 10), dtype=dtype)
    got = _emulated(q, k, v, bias, g, rate)
    want = att.attention_dropout_bwd_ref(q, k, v, bias, g, HEADS, rate, SEED)
    errs = {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = w.float()
        err = (a - w).abs()
        assert torch.isfinite(a).all(), name
        assert bool((err <= bound[0] + bound[1] * w.abs()).all()), (
            f"{name}: max |emulated - plain| {err.max().item():.3e}")
        errs[name] = err.max().item()
    return errs


@pytest.mark.parametrize("rate", [RATE, 0.0], ids=["5L", "3L"])
@pytest.mark.parametrize("s", SHAPES)
def test_d_from_the_output_keeps_dq_dk_dv_within_the_card_bound(s, rate):
    for name, err in _route_errors(s, rate, torch.bfloat16, BOUND).items():
        # With room to spare: 3.4e-3 - 1.3e-2 at these seeds, where the
        # outputs reach 0.9 - 2.3.
        assert err < BOUND[0] / 2, (name, err)


@pytest.mark.parametrize("rate", [RATE, 0.0], ids=["5L", "3L"])
@pytest.mark.parametrize("s", SHAPES)
def test_f32_d_from_the_output_keeps_dq_dk_dv_within_the_f32_bar(s, rate):
    # In f32 D from the output differs from rowsum(dP P) by round-off alone.
    for name, err in _route_errors(s, rate, torch.float32, F32_BOUND).items():
        assert err < F32_BOUND[0] / 10, (name, err)


@pytest.mark.parametrize("dropout", [True, False], ids=["dropout", "no dropout"])
@pytest.mark.parametrize("s", [76, 165])
def test_plain_pair_dq_dk_dv_do_not_depend_on_the_bias_gradient(s, dropout):
    q, k, v, g, bias = _inputs(s, seed=s + 7)
    q, k, v, g = (t.float() for t in (q, k, v, g))
    grads = []
    for bias_grad in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        b = bias.clone().requires_grad_(bias_grad)
        if dropout:
            out = att.fused_attention_dropout(*leaves, b, num_heads=HEADS, rate=RATE, seed=SEED)
        else:
            out = att.fused_attention(*leaves, b, num_heads=HEADS)
        out.backward(g)
        assert (b.grad is not None) == bias_grad
        grads.append([leaf.grad for leaf in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_long_backward_refuses_an_out_that_does_not_go_with_dbias():
    q, k, v, g, bias = (t.float() for t in _inputs(76, seed=1))
    lse = torch.zeros(2, HEADS, 76, 2)
    with pytest.raises(ValueError, match="dbias=False takes the forward's output"):
        att._long_bwd("fused_attention_long_bwd_cuda", "", q, k, v, bias, g, HEADS, lse, dbias=False)
    with pytest.raises(ValueError, match="dbias=False takes the forward's output"):
        att._long_bwd("fused_attention_long_bwd_cuda", "", q, k, v, bias, g, HEADS, lse, dbias=False,
                      out=q[:, :10])
    with pytest.raises(ValueError, match="out is taken only with dbias=False"):
        att._long_bwd("fused_attention_long_bwd_cuda", "", q, k, v, bias, g, HEADS, lse, out=q)
