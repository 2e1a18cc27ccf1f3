"""The head-fold experiment on the H100: F heads' attention as one stacked
product.

    python -m rgqa_tpu_torch.experiments.headfold_exp [--batch 384] [--iters 50] [--device cpu]

Port of ``experiments/headfold_exp.py``.  Per (batch row, group of F
heads) the F heads' (Sq, 64) query slices are stacked into one (F Sq, 64)
matrix and their keys into (F Skv, 64); one (F Sq) x (F Skv) score
product, with the cross-head quadrants at -1e9 (exactly 0 after exp in
f32), gives every head's softmax, and one (F Sq) x (F Skv) x 64 product
every head's context.  The function is kernel #1's; the work adds the
masked quadrants' products, and the question is whether the taller
products fill the tensor cores' tiles better (on ``mma.sync`` m16n8k16 a
20-row head pads to 32 rows, two stacked heads, 40 rows, to 48).

Variants, as the TPU script (``:249-254``): ``concat`` stacks F = 2
same-parity heads ((0, 2), (4, 6), ..., (1, 3), ...); ``scratch`` stacks
F consecutive heads, F in {2, 3, 4, 6}.  Here both are one kernel
(``csrc/headfold.cu``) that takes F and the head order.  The TPU
script's block size ``bt`` and scoped-VMEM limit ``vmem_mb`` are gone:
they sized Mosaic's VMEM blocks (ROADMAP "Not to port").  The kernel's
bf16 body runs on Hopper's warpgroup products: one tile of stacked query
rows per block, as many whole heads as fit in ``wgmma``'s 64 rows,
against the keys of those heads only (:func:`fold_plan`); the keys
outside the window carry the -1e9 and are dropped, which leaves the
function as it is (:func:`headfold_window_ref` computes it that way).
The shipped form is kernel #1 (F = 1), timed beside every (variant, F).
"""

from __future__ import annotations

import typing

import torch

from rgqa_tpu_torch import experiments as X
from rgqa_tpu_torch.ops import attention as att

__all__ = ["headfold", "headfold_ref", "headfold_window_ref", "headfold_cuda", "head_order", "fold_plan",
           "FoldPlan", "window_smem_bytes", "SHAPES", "CANDIDATES", "main"]

SHAPES = ((56, 56), (36, 36), (20, 36), (36, 20), (20, 20))  # the TPU script's (:237)
CANDIDATES = (("concat", 2), ("scratch", 2), ("scratch", 3), ("scratch", 4), ("scratch", 6))
FOLDS = (2, 3, 4, 6)
MAX_STACKED_KEYS = 384  # csrc/headfold.cu kFoldMaxKeys: the f32 body's F Skv
TILE_ROWS = 64  # csrc/headfold.cu kFoldTileRows: wgmma's M, the most stacked query rows per block
MAX_WINDOW_KEYS = 256  # csrc/headfold.cu kFoldMaxWindowKeys: wgmma's largest N

_ARGS = (X.P_,) * 5 + (X.I_,) * 8 + (X.P_,) + (X.LL_,) * 6 + (X.F_, X.P_)


def head_order(num_heads: int, fold: int, variant: str) -> list:
    """The heads in group order: group g is ``order[g F:(g + 1) F]``.
    ``scratch``: consecutive heads; ``concat`` (F = 2): pairs of heads of
    one parity, the evens first, as the TPU script's ``groups`` (:154)."""
    if variant == "scratch":
        if fold not in FOLDS or num_heads % fold:
            raise ValueError(f"headfold: fold {fold} must be one of {FOLDS} and divide {num_heads} heads")
        return list(range(num_heads))
    if variant == "concat":
        if fold != 2 or num_heads % 4:
            raise ValueError(f"headfold: the concat variant stacks 2 heads of one parity, got fold {fold}, "
                             f"{num_heads} heads")
        evens, odds = list(range(0, num_heads, 2)), list(range(1, num_heads, 2))
        return evens + odds
    raise ValueError(f"headfold: variant {variant!r} is neither 'scratch' nor 'concat'")


class FoldPlan(typing.NamedTuple):
    """How the bf16 body cuts a group's stack: ``tiles`` holds (q0, rows,
    h0) per tile of at most ``TILE_ROWS`` stacked query rows, h0 the first
    of the ``heads`` group positions in its key window; ``keys`` = heads x
    Skv; ``n`` the keys rounded up to 16 (``wgmma``'s N for S = Q K^T and
    the 16-key steps of P V)."""

    tiles: tuple
    heads: int
    keys: int
    n: int


def fold_plan(sq: int, skv: int, fold: int) -> FoldPlan:
    """The tiles of a group's stacked query rows and their key windows, as
    ``csrc/headfold.cu`` launches them (it is handed ``heads`` and checks
    the rest): each tile holds W whole heads, the most that fit in
    ``wgmma``'s 64 rows (one head of more than 32 rows) with W Skv keys
    within its largest N (256), and its window is those W heads, shifted
    back to stay inside the group in a last tile of fewer heads.  Each
    row's own head lies in its tile's window.  Measured on the H100
    against tiles of 64 rows cut across heads, with windows of every head
    they touch (PERF.md section 6): whole heads win or tie at 24 of the
    experiment's 25 (shape, F) cases."""
    heads = max(1, min(fold, TILE_ROWS // sq, MAX_WINDOW_KEYS // skv))
    rows, stacked = heads * sq, fold * sq
    tiles = tuple((q0, min(rows, stacked - q0), min(q0 // sq, fold - heads)) for q0 in range(0, stacked, rows))
    keys = heads * skv
    return FoldPlan(tiles, heads, keys, -(-keys // 16) * 16)


def window_smem_bytes(n: int) -> int:
    """The bf16 body's dynamic shared memory for a window of ``n`` keys (a
    multiple of 16), from the built kernel (builds ``csrc/headfold.cu``)."""
    fn, _ = X.bind("headfold", "rgqa_headfold_window_smem", (X.I_,))
    nbytes = fn(n)
    if nbytes < 0:
        raise ValueError(f"window_smem_bytes: {n} keys is not a window of the bf16 body")
    return nbytes


def _fold(q, k, v, bias, fold: int, variant: str, num_heads: int, tiles, window: int):
    """Per group of F heads stacked along the rows, per tile (q0, rows, h0)
    of stacked query rows against the keys of group positions h0 .. h0 +
    window - 1: scores in f32 plus the bias repeated per head plus -1e9
    off the row's head, softmax in f32, P rounded to the input dtype, the
    PV product in f32, each head's rows back to its columns."""
    order = head_order(num_heads, fold, variant)
    b, sq, e = q.shape
    skv, d = k.shape[1], e // num_heads
    groups = num_heads // fold
    acc = torch.promote_types(q.dtype, torch.float32)
    idx = torch.tensor(order, device=q.device)

    def stack(t):  # (B, S, H*D) -> (B, G, F*S, D), heads in group order
        s = t.shape[1]
        heads = t.reshape(b, s, num_heads, d)[:, :, idx].to(acc)
        return heads.reshape(b, s, groups, fold, d).permute(0, 2, 3, 1, 4).reshape(b, groups, fold * s, d)

    qs, ks, vs = stack(q), stack(k), stack(v)
    bias_win = bias.to(acc).repeat(1, window)[:, None, None, :]
    colg = torch.arange(window * skv, device=q.device) // skv
    o = torch.empty_like(qs)
    for q0, rows, h0 in tiles:
        rowg = torch.arange(q0, q0 + rows, device=q.device) // sq - h0
        struct = torch.where(rowg[:, None] == colg[None, :], 0.0, -1e9).to(acc)
        keys = slice(h0 * skv, (h0 + window) * skv)
        s = torch.einsum("bgqd,bgkd->bgqk", qs[:, :, q0:q0 + rows], ks[:, :, keys]) * (1.0 / d ** 0.5)
        s = s + bias_win + struct
        ex = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = (ex / ex.sum(dim=-1, keepdim=True)).to(q.dtype).to(acc)
        o[:, :, q0:q0 + rows] = torch.einsum("bgqk,bgkd->bgqd", p, vs[:, :, keys])
    o = o.reshape(b, groups, fold, sq, d).permute(0, 3, 1, 2, 4).reshape(b, sq, num_heads, d)
    out = torch.empty_like(o)
    out[:, :, idx] = o
    return out.reshape(b, sq, e).to(q.dtype)


def headfold_ref(q, k, v, bias, fold: int, variant: str = "scratch", num_heads: int = X.H):
    """The plain version of :func:`headfold_cuda`, the TPU body's stacked
    product step by step: per group the F heads' q, k, v stacked along the
    rows, one (F Sq) x (F Skv) score product with -1e9 off the
    head-diagonal blocks, softmax, P rounded to the input dtype, the
    stacked PV product (see ``_fold``)."""
    return _fold(q, k, v, bias, fold, variant, num_heads, ((0, fold * q.shape[1], 0),), fold)


def headfold_window_ref(q, k, v, bias, fold: int, variant: str = "scratch", num_heads: int = X.H):
    """:func:`headfold_ref` computed as the bf16 body cuts it: each tile of
    :func:`fold_plan` over its key window only."""
    plan = fold_plan(q.shape[1], k.shape[1], fold)
    return _fold(q, k, v, bias, fold, variant, num_heads, plan.tiles, plan.heads)


def headfold_cuda(q, k, v, bias, fold: int, variant: str = "scratch", num_heads: int = X.H):
    """Launch ``csrc/headfold.cu``: each head's attention, F heads stacked
    as :func:`headfold_ref` describes (bf16: per tile of whole heads over
    its key window, :func:`fold_plan`).  q, k, v may be strided views with
    a contiguous last dim; ``bias`` a contiguous (B, Skv) f32 tensor; Sq,
    Skv <= 64 and F Skv <= 384.  Returns a new contiguous (B, Sq, E)
    tensor; ``headfold_cuda.launches`` counts the launches."""
    name = "headfold_cuda"
    att._check(name, q, k, v, bias, num_heads)
    order = head_order(num_heads, fold, variant)
    b, sq, e = q.shape
    skv, d = k.shape[1], e // num_heads
    if fold * skv > MAX_STACKED_KEYS:
        raise ValueError(f"{name}: {fold} x {skv} stacked keys exceed {MAX_STACKED_KEYS}")
    plan = fold_plan(sq, skv, fold)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    order_c = (X.I_ * num_heads)(*order)
    X.call(
        name, "headfold", "rgqa_headfold", _ARGS, q.device,
        *(t.data_ptr() for t in (q, k, v, bias, out)),
        X.dtype_code(q), b, sq, skv, num_heads, d, fold, plan.heads, order_c,
        *X.strides(q, k, v), d ** -0.5,
    )
    headfold_cuda.launches += 1
    return out


headfold_cuda.launches = 0


def headfold(q, k, v, bias, fold: int, variant: str = "scratch", num_heads: int = X.H):
    """Head-folded attention: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = headfold_ref if q.device.type == "cpu" else headfold_cuda
    return fn(q, k, v, bias, fold, variant, num_heads)


def main(argv=None) -> dict:
    args, device = X.parse_args(argv, __doc__.split("\n\n")[0])
    print(X.describe(device), f"batch {args.batch}, bf16" if device.type == "cuda" else "", flush=True)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    table = X.Table(device, args.iters)
    gen = torch.Generator(device=device).manual_seed(0)
    for sq, skv in SHAPES:
        q, k, v = (torch.randn(args.batch, s, X.E, generator=gen, device=device).to(dtype)
                   for s in (sq, skv, skv))
        m = torch.zeros(args.batch, skv, device=device)
        if device.type == "cuda":
            shipped = lambda: att.fused_attention_cuda(q, k, v, m, X.H)  # noqa: E731
        else:
            shipped = lambda: att.attention_natural_ref(q, k, v, m, X.H)  # noqa: E731
        base = shipped()
        base_us = table.time_us(shipped)
        ref = X.attend_ref(q, k, v, m, X.H) if device.type == "cuda" else base
        table.row(f"{sq}x{skv}: shipped (#1, F = 1)", base_us, base_us, X.max_diff(base, ref))
        for variant, fold in CANDIDATES:
            got = headfold(q, k, v, m, fold, variant)
            plain = headfold_ref(q, k, v, m, fold, variant) if device.type == "cuda" else base
            us = table.time_us(lambda fold=fold, variant=variant: headfold(q, k, v, m, fold, variant))
            table.row(f"{sq}x{skv}: {variant} F = {fold}", us, base_us, X.max_diff(got, plain))
    launches = X.print_launches((headfold_cuda,))
    return {"rows": table.rows, "launches": launches}


if __name__ == "__main__":
    main()
