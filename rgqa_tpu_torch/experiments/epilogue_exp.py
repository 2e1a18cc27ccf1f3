"""The attention-epilogue experiment on the H100: attention, output
projection, bias, residual and LayerNorm in one kernel.

    python -m rgqa_tpu_torch.experiments.epilogue_exp [--batch 384] [--iters 50] [--device cpu]

Port of ``experiments/epilogue_exp.py``.  For each of LXMERT's four
attention shapes at batch 384 it times

- ``split``, the shipped form: kernel #1 (``fused_attention_cuda``), then
  ``torch.addmm`` for the out-projection, the residual add and the port's
  ``LayerNorm`` (``models/transformer.py``), as a model layer runs them;
- ``fused``: :func:`epi_fused` (``csrc/epilogue.cu``, replacing
  ``_epi_kernel``), which keeps each 64-row block's context on chip in
  the layout the tensor cores read, projects it with ``wgmma`` while W
  streams in by TMA, and normalises the rows before it writes them once.

The question on this card: do the LayerNorm, residual and projection
passes that ``split`` runs over device memory cost more than the fused
kernel's re-reads of W from L2 (every block reads all of it) and its one
block per SM?
"""

from __future__ import annotations

import functools
import math
import typing

import numpy as np
import torch

from rgqa_tpu_torch import experiments as X
from rgqa_tpu_torch.models.transformer import LayerNorm
from rgqa_tpu_torch.ops import attention as att

__all__ = ["epi_fused", "epi_fused_ref", "epi_fused_cuda", "epi_plan", "epi_smem_bytes", "EpiPlan",
           "split", "SHAPES", "EPS", "main"]

SHAPES = ((20, 20), (36, 36), (20, 36), (36, 20))
EPS = 1e-12
ROWS = 64  # csrc/epilogue.cu kEpiRows: a block's output rows, wgmma's M
MAX_WINDOW_KEYS = 96  # kMaxWindowKeys: a window's keys, padded to 16
SMEM_MAX = 232448  # 227 KB, the most shared memory a block may take

_ARGS = (X.P_,) * 10 + (X.I_,) * 8 + (X.LL_,) * 6 + (X.F_, X.F_, X.P_)


class EpiPlan(typing.NamedTuple):
    """The bf16 body's launch: ``blocks`` of ``ROWS`` output rows, the
    most batch rows (segments) one spans, ``per_window`` segments a key
    window, the window's ``keys`` padded to 16, and the block's dynamic
    shared memory in bytes."""

    blocks: int
    segments: int
    per_window: int
    keys: int
    smem: int


def _block_segments(total: int, sq: int, blk: int) -> range:
    """The batch rows block ``blk`` of the flattened (B Sq) rows spans."""
    r0 = blk * ROWS
    return range(r0 // sq, (min(r0 + ROWS, total) - 1) // sq + 1)


def epi_smem_bytes(keys: int) -> int:
    """The bf16 body's dynamic shared memory for a window of ``keys`` (a
    multiple of 16), as ``epi_layout`` in ``csrc/epilogue.cu`` lays it
    out: the 64 x 768 bf16 tile (96 KB); a region of max(the W ring, 5
    items of 64 x 192 bf16; the attention buffers, per warpgroup K and V
    of ``keys`` 128-byte rows and two bias rows of ``keys`` f32, rounded to
    1 KB); 512 bytes of mbarriers; the LayerNorm's 2 x 4 x 64 f32 partial
    sums; one more KB to align."""
    ring = 5 * 64 * 192 * 2
    attn = 4 * -(-(2 * 128 * keys + 2 * 4 * keys) // 1024) * 1024
    return 96 * 1024 + max(ring, attn) + 512 + 2 * 4 * ROWS * 4 + 1024


@functools.lru_cache(maxsize=None)
def epi_plan(batch: int, sq: int, skv: int) -> EpiPlan:
    """The windows of whole segments the bf16 body walks, per head, in each
    block: as many segments as fit ``MAX_WINDOW_KEYS`` keys (a register
    budget: the body holds the window's scores), spread evenly over as
    few windows as the widest block needs.  The blocks' row offsets repeat
    every ``sq / gcd(64, sq)`` blocks, so those and the last block give the
    widest."""
    total = batch * sq
    blocks = -(-total // ROWS)
    period = sq // math.gcd(ROWS, sq)
    segments = max(len(_block_segments(total, sq, j)) for j in (*range(min(blocks, period)), blocks - 1))
    most = max(1, min(segments, MAX_WINDOW_KEYS // skv))
    per_window = -(-segments // -(-segments // most))
    keys = -(-per_window * skv // 16) * 16
    return EpiPlan(blocks, segments, per_window, keys, epi_smem_bytes(keys))


def epi_fused_ref(q, k, v, mask, res, w, b, g, be, num_heads: int = X.H):
    """The plain version of :func:`epi_fused_cuda`, as ``_epi_kernel``
    computes it: each head's context rounded to the input dtype, ``y =
    ctx @ w + b + res`` in f32 (``w`` (E, E), in x out), LayerNorm over E
    with f32 statistics (eps 1e-12), times ``g`` plus ``be``, in the input
    dtype."""
    acc = torch.promote_types(q.dtype, torch.float32)
    ctx = X.attend_ref(q, k, v, mask, num_heads).to(acc)
    y = ctx @ w.to(acc) + b.to(acc) + res.to(acc)
    mu = y.mean(dim=-1, keepdim=True)
    var = (y - mu).square().mean(dim=-1, keepdim=True)
    z = (y - mu) * torch.rsqrt(var + EPS)
    return (z * g.to(acc) + be.to(acc)).to(q.dtype)


def _check_epilogue(name, q, k, v, mask, res, w, b, g, be, num_heads: int) -> None:
    att._check(name, q, k, v, mask, num_heads)
    if q.shape[2] != X.E or num_heads != X.H:
        raise ValueError(f"{name}: the kernel takes E = {X.E} in {X.H} heads, "
                         f"got E = {q.shape[2]}, {num_heads} heads")
    X.check_vector(name, "res", res, tuple(q.shape), q.dtype, q.device)
    X.check_vector(name, "w", w, (X.E, X.E), q.dtype, q.device)
    if w.data_ptr() % 16:
        raise ValueError(f"{name}: w must be 16-byte aligned")
    for what, t in (("b", b), ("g", g), ("be", be)):
        X.check_vector(name, what, t, (X.E,), torch.float32, q.device)


def epi_fused_cuda(q, k, v, mask, res, w, b, g, be, num_heads: int = X.H):
    """Launch ``csrc/epilogue.cu``: :func:`epi_fused_ref`'s function.
    q, k, v (B, S, 768) may be strided views with a contiguous last dim,
    ``mask`` a contiguous (B, Skv) f32 bias, ``res`` (B, Sq, 768) and
    ``w`` (768, 768) contiguous in q's dtype, ``b``, ``g``, ``be`` (768,)
    f32; Sq, Skv <= 64.  Returns a new contiguous (B, Sq, 768) tensor;
    ``epi_fused_cuda.launches`` counts the launches."""
    name = "epi_fused_cuda"
    _check_epilogue(name, q, k, v, mask, res, w, b, g, be, num_heads)
    if res.data_ptr() % 16:
        raise ValueError(f"{name}: res must be 16-byte aligned")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    bsz, sq, e = q.shape
    d = e // num_heads
    plan = epi_plan(bsz, sq, k.shape[1])
    X.call(
        name, "epilogue", "rgqa_epilogue", _ARGS, q.device,
        *(t.data_ptr() for t in (q, k, v, mask, res, w, b, g, be, out)),
        X.dtype_code(q), bsz, sq, k.shape[1], num_heads, d, plan.per_window, plan.keys,
        *X.strides(q, k, v), d ** -0.5, EPS,
    )
    epi_fused_cuda.launches += 1
    return out


epi_fused_cuda.launches = 0


def epi_fused(q, k, v, mask, res, w, b, g, be, num_heads: int = X.H):
    """The fused attention epilogue: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    fn = epi_fused_ref if q.device.type == "cpu" else epi_fused_cuda
    return fn(q, k, v, mask, res, w, b, g, be, num_heads)


def layer_norm(g, be) -> LayerNorm:
    """The port's LayerNorm (eps 1e-12) holding ``g`` and ``be``, without
    gradients (``split`` is timed as inference)."""
    ln = LayerNorm(g.shape[0], EPS).to(g.device).requires_grad_(False)
    ln.weight.copy_(g)
    ln.bias.copy_(be)
    return ln


def split(q, k, v, mask, res, w, b, ln: LayerNorm, num_heads: int = X.H):
    """The shipped form: attention through kernel #1 (its plain version on
    the CPU), ``torch.addmm`` in the input dtype for the out-projection,
    the residual add, then the port's :class:`LayerNorm` ``ln``."""
    attention = att.attention_natural_ref if q.device.type == "cpu" else att.fused_attention_cuda
    ctx = attention(q, k, v, mask, num_heads)
    bsz, sq, e = ctx.shape
    y = torch.addmm(b.to(q.dtype), ctx.reshape(-1, e), w).reshape(bsz, sq, e) + res
    return ln(y)


def make_inputs(b: int, sq: int, skv: int, device, dtype, rng) -> tuple:
    """The TPU script's inputs (:118-126), from a numpy generator: q, k, v,
    res normal; w normal x 0.02; b, be normal x 0.02; g 1 + normal x 0.02;
    the mask zeros."""
    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dt)

    q = t(rng.standard_normal((b, sq, X.E)))
    k = t(rng.standard_normal((b, skv, X.E)))
    v = t(rng.standard_normal((b, skv, X.E)))
    mask = torch.zeros(b, skv, device=device)
    res = t(rng.standard_normal((b, sq, X.E)))
    w = t(rng.standard_normal((X.E, X.E)) * 0.02)
    bias = t(rng.standard_normal(X.E) * 0.02, torch.float32)
    g = t(1.0 + rng.standard_normal(X.E) * 0.02, torch.float32)
    be = t(rng.standard_normal(X.E) * 0.02, torch.float32)
    return q, k, v, mask, res, w, bias, g, be


def main(argv=None) -> dict:
    args, device = X.parse_args(argv, __doc__.split("\n\n")[0])
    print(X.describe(device), f"batch {args.batch}, bf16" if device.type == "cuda" else "", flush=True)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    table = X.Table(device, args.iters)
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        for sq, skv in SHAPES:
            q, k, v, mask, res, w, b, g, be = make_inputs(args.batch, sq, skv, device, dtype, rng)
            ln = layer_norm(g, be)
            shipped = split(q, k, v, mask, res, w, b, ln)
            ref = epi_fused_ref(q, k, v, mask, res, w, b, g, be) if device.type == "cuda" else shipped
            base_us = table.time_us(lambda: split(q, k, v, mask, res, w, b, ln))
            table.row(f"{sq}x{skv}: split (shipped)", base_us, base_us, X.max_diff(shipped, ref))
            got = epi_fused(q, k, v, mask, res, w, b, g, be)
            us = table.time_us(lambda: epi_fused(q, k, v, mask, res, w, b, g, be))
            table.row(f"{sq}x{skv}: fused", us, base_us, X.max_diff(got, ref))
    launches = X.print_launches((epi_fused_cuda,))
    return {"rows": table.rows, "launches": launches}


if __name__ == "__main__":
    main()
