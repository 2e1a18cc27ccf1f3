"""Multi-head attention on the natural (B, S, H*D) layout, forward and
backward, with and without attention-probability dropout.

Port of ``rgqa_tpu/ops/attention.py``.  Eight hand-written Hopper kernels,
each with a plain PyTorch version beside it:

| kernel (wrapper) | source | TPU kernel it replaces | plain version |
| --- | --- | --- | --- |
| :func:`fused_attention_cuda` | ``csrc/fused_attention.cu`` | ``_fused_kernel`` | :func:`attention_natural_ref` |
| :func:`fused_attention_long_cuda` | ``csrc/fused_attention_long.cu`` | ``_fused_kernel`` on the query-tiled grid (``_fused_qblocked_raw``) and at long streams | :func:`attention_natural_ref` |
| :func:`fused_attention_bwd_cuda` | ``csrc/fused_attention_bwd.cu`` | ``_fused_bwd_kernel`` | :func:`attention_bwd_ref` |
| :func:`fused_attention_long_bwd_cuda` | ``csrc/fused_attention_long_bwd.cu`` | ``_fused_bwd_kernel`` at long streams (``_fit_bwd_block``'s raised tiers) | :func:`attention_bwd_ref` |
| :func:`fused_attention_dropout_cuda` | ``csrc/fused_attention_dropout.cu`` | ``_fused_drop_kernel`` | :func:`attention_dropout_ref` |
| :func:`fused_attention_dropout_bwd_cuda` | ``csrc/fused_attention_dropout.cu`` | ``_fused_drop_bwd_kernel`` | :func:`attention_dropout_bwd_ref` |
| :func:`fused_attention_dropout_long_cuda` | ``csrc/fused_attention_long.cu`` | ``_fused_drop_kernel`` at long streams | :func:`attention_dropout_ref` |
| :func:`fused_attention_dropout_long_bwd_cuda` | ``csrc/fused_attention_long_bwd.cu`` | ``_fused_drop_bwd_kernel`` at long streams | :func:`attention_dropout_bwd_ref` |

:func:`fused_attention` and :func:`fused_attention_dropout` are
``torch.autograd.Function``s (the ``_fused`` / ``_fused_drop``
custom_vjps): on CUDA tensors their forward and backward launch the
kernels, on CPU tensors they run the plain versions.  A CUDA tensor
reaches a kernel or raises; there is no fallback.  The forward and the
backward pick their kernels by length (:func:`forward_kernel`,
:func:`backward_kernel`): Sq, Skv <= 64 the short kernels, longer
streams the long ones, at any length (ViLT-B/32's 165-185 tokens, 277 at
a 512 px image, 597 with 16 px patches; head dim <= 64 throughout).
The long forward runs an online softmax over tiles of 64 keys (in bf16
on Hopper's warpgroup products at every length; in f32 over whole rows
up to 256 keys and key tiles beyond); when autograd
will need the backward it also writes each row's softmax statistics (max
and log-sum, whose sum is the log-sum-exp), which the long backward
takes instead of recomputing the softmax: its dQ pass
walks the key tiles, its dK/dV pass the query tiles.  Each row's D =
rowsum(dP P) takes a sweep of the keys of its own when the bias takes a
gradient; otherwise (every model path) the dQ pass takes it as
rowsum(g o out) from the forward's saved output, and no dbias is
computed.  The dropout pair picks its kernels the same way
(:func:`dropout_forward_kernel`, :func:`dropout_backward_kernel`): #4 /
#5 up to 64 tokens, and beyond, 4L / 5L, the long forward and backward
with the mask applied to P (the softmax sum and the row statistics stay
the undropped P's) and replayed in both backward passes, at any length
(UNITER's 76-token stream with 40-token questions).
``force_xla=True`` runs the plain forward under PyTorch's own autograd
instead.

The dropout mask is keyed on the element: keep(b, h, i, j) is a pure
function of a 64-bit seed and (b, h, i, j), one byte of a Philox4x32-10
draw, kept iff ``byte >= t`` with ``t = round(rate * 256)`` and kept
probabilities scaled by ``256 / (256 - t)``.  So the backward replays the
forward's mask exactly, whatever the launch geometry, and
:func:`dropout_keep_mask_ref` computes the same bits with integer tensor
ops.  The bits cannot match the TPU's hardware generator: the contract is
that of ``_attention_dropout_xla`` (quantized rate, exact expectation).

The TPU kernels' VMEM block ladder (``_fit_block``, ``_fwd_plan``,
``_fit_qblock``, ``_fit_bwd_block``) has no counterpart: one thread block
per (batch row, head), and per query tile of 64 rows in the long forward
(per batch row and pair of heads, in turn, in the short bf16 backward),
holds its whole problem in shared memory, or, at more than 256 keys,
streams the keys through it in tiles; the long backward splits its work
into a pass over query tiles and one over key tiles, both key- or
query-tiled, so no block holds a row-wide array.  What bounds each
kernel on the H100, and how many blocks share an SM, is in its source's
header.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from rgqa_tpu_torch.ops._build import load_library
from rgqa_tpu_torch.ops.dropout import keep_threshold

__all__ = [
    "MAX_SEQ",
    "MAX_HEAD_DIM",
    "forward_kernel",
    "backward_kernel",
    "bias_vector",
    "attention_probs",
    "attention_natural_ref",
    "attention_bwd_ref",
    "dropout_keep_mask_ref",
    "attention_dropout_ref",
    "attention_dropout_bwd_ref",
    "fused_attention",
    "fused_attention_dropout",
    "fused_attention_cuda",
    "fused_attention_long_cuda",
    "fused_attention_bwd_cuda",
    "fused_attention_long_bwd_cuda",
    "fused_attention_dropout_cuda",
    "fused_attention_dropout_bwd_cuda",
    "fused_attention_dropout_long_cuda",
    "fused_attention_dropout_long_bwd_cuda",
    "dropout_forward_kernel",
    "dropout_backward_kernel",
]

# The kernels' limits (csrc/attention_common.cuh kMaxSeq / kMaxDim): the
# short kernels take Sq, Skv <= MAX_SEQ; the long forward and backward any
# Sq and Skv; every kernel D <= MAX_HEAD_DIM.
MAX_SEQ = 64
MAX_HEAD_DIM = 64

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def bias_vector(
    bias: Optional[torch.Tensor], b: int, skv: int,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Normalize an additive mask to the kernel's contiguous (B, Skv) f32
    form; ``bias`` is None, ``(B, Skv)`` or broadcastable ``(B, 1, 1, Skv)``."""
    if bias is None:
        return torch.zeros((b, skv), dtype=torch.float32, device=device)
    if bias.dim() == 4:
        bias = bias[:, 0, 0, :]
    return torch.broadcast_to(bias, (b, skv)).to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# Plain versions.  The accumulation dtype is f32 for f32 and bf16 inputs
# (f64 for f64 inputs, for gradcheck).
# ---------------------------------------------------------------------------


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, e = t.shape
    return t.reshape(b, s, num_heads, e // num_heads)


def _probs(q, k, bias_kv, num_heads: int) -> torch.Tensor:
    """(B, H, Sq, Skv) softmax of the scores as ``_attention_natural_xla``
    takes them: products in the input dtype, then f32 plus the bias."""
    d = q.shape[-1] // num_heads
    scores = torch.einsum("bqhd,bkhd->bhqk", _heads(q, num_heads), _heads(k, num_heads))
    scores = (scores / math.sqrt(d)).to(_acc(q.dtype)) + bias_kv[:, None, None, :]
    return torch.softmax(scores, dim=-1)


def _pv(probs, v, num_heads: int, out_dtype) -> torch.Tensor:
    b, skv, e = v.shape
    out = torch.einsum("bhqk,bkhd->bqhd", probs, _heads(v, num_heads).to(probs.dtype))
    return out.reshape(b, -1, e).to(out_dtype)


def attention_probs(q, k, bias, num_heads: int) -> torch.Tensor:
    """(B, H, Sq, Skv) f32 attention probabilities of natural-layout q, k
    (the JAX package's ``attention_probs``, for the visualisation path):
    the scores in the input dtype plus ``bias`` (None or broadcastable to
    the scores, e.g. ``(B, 1, 1, Skv)``), the softmax in f32."""
    d = q.shape[-1] // num_heads
    scores = torch.einsum("bqhd,bkhd->bhqk", _heads(q, num_heads), _heads(k, num_heads)) / math.sqrt(d)
    if bias is not None:
        scores = scores + bias
    return torch.softmax(scores.float(), dim=-1)


def attention_natural_ref(q, k, v, bias_kv, num_heads: int) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d) + bias) v`` per head, plain PyTorch
    (``_attention_natural_xla``): scores cast to f32, f32 softmax, PV in
    f32, output in the input dtype."""
    return _pv(_probs(q, k, bias_kv, num_heads), v, num_heads, q.dtype)


def _bwd_ref(q, k, v, bias_kv, g, num_heads: int, drop=None):
    """The backward of ``_fused_bwd_kernel`` (``drop`` None) or of
    ``_fused_drop_bwd_kernel`` (``drop = (keep, keep_scale)``), step by
    step in the accumulation dtype: P recomputed from products of the
    inputs, dP and dV from g and v in that dtype, dS rounded to the input
    dtype before the dQ and dK products."""
    b, sq, e = q.shape
    skv = k.shape[1]
    d = e // num_heads
    scale = 1.0 / math.sqrt(d)
    acc = _acc(q.dtype)
    qh, kh, vh = (_heads(t, num_heads).to(acc) for t in (q, k, v))
    gh = _heads(g.to(q.dtype), num_heads).to(acc)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale + bias_kv.to(acc)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, vh)
    p_v = p
    if drop is not None:
        keep, keep_scale = drop
        p_v = torch.where(keep, p * keep_scale, 0.0)
        dp = torch.where(keep, dp * keep_scale, 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_v, gh)
    ds_nb = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dbias = ds_nb.sum(dim=(1, 2))  # over heads and query rows
    ds = (ds_nb * scale).to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh)
    return (
        dq.reshape(b, sq, e).to(q.dtype),
        dk.reshape(b, skv, e).to(k.dtype),
        dv.reshape(b, skv, e).to(v.dtype),
        dbias.to(bias_kv.dtype),
    )


def attention_bwd_ref(q, k, v, bias_kv, g, num_heads: int):
    """(dq, dk, dv, dbias) of :func:`attention_natural_ref` for the output
    gradient ``g``, as ``_fused_bwd_kernel`` computes them: dP = g V^T and
    dV = P^T g in f32, dS = P (dP - rowsum(dP P)), dQ = (dS/sqrt(d)) K and
    dK = (dS/sqrt(d))^T Q with dS rounded to the input dtype, dbias = the
    sum of dS over heads and query rows (f32, (B, Skv))."""
    return _bwd_ref(q, k, v, bias_kv, g, num_heads)


# Philox4x32-10 (Salmon et al., SC'11): the constants of Random123.
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product of ``a`` (uint32
    values in an int64 tensor) and the constant ``m``, without leaving
    int64: ``m`` is split into 16-bit halves."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def _philox4x32_10(c0, c1, c2, c3, seed: int):
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def dropout_keep_mask_ref(
    seed: int, b: int, h: int, sq: int, skv: int, rate: float,
    device: Optional[torch.device | str] = None,
) -> torch.Tensor:
    """The (B, H, Sq, Skv) bool keep mask the dropout kernels draw.

    Element (b, h, i, j) takes byte ``j % 16`` (little-endian, word
    ``(j % 16) // 4``) of Philox4x32-10 at counter ``(j // 16, i, h, b)``
    under key ``(seed & 0xFFFFFFFF, seed >> 32)``, and is kept iff that
    byte is ``>= round(rate * 256)``.  uint32 arithmetic in int64
    tensors, masked to 32 bits."""
    t, _ = keep_threshold(rate)
    groups = (skv + 15) // 16
    bb, hh, ii, gg = torch.meshgrid(
        *(torch.arange(n, dtype=torch.int64, device=device) for n in (b, h, sq, groups)),
        indexing="ij",
    )
    words = torch.stack(_philox4x32_10(gg, ii, hh, bb, int(seed)), dim=-1)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=device)
    byte = (words[..., None] >> shifts) & 0xFF  # (B, H, Sq, groups, word, byte)
    return byte.reshape(b, h, sq, groups * 16)[..., :skv] >= t


def _drop(q, k, num_heads: int, rate: float, seed: int):
    t, keep_p = keep_threshold(rate)
    keep = dropout_keep_mask_ref(
        seed, q.shape[0], num_heads, q.shape[1], k.shape[1], rate, device=q.device
    )
    return keep, 1.0 / keep_p


def attention_dropout_ref(q, k, v, bias_kv, num_heads: int, rate: float, seed: int):
    """:func:`attention_natural_ref` with the kernels' mask on P: kept
    probabilities scaled by ``1 / keep_p``, the rest zero."""
    keep, keep_scale = _drop(q, k, num_heads, rate, seed)
    probs = _probs(q, k, bias_kv, num_heads)
    return _pv(torch.where(keep, probs * keep_scale, 0.0), v, num_heads, q.dtype)


def attention_dropout_bwd_ref(q, k, v, bias_kv, g, num_heads: int, rate: float, seed: int):
    """The backward of the dropout kernel (``_fused_drop_bwd_kernel``):
    dV from the dropped P, dP masked and scaled before dS, the rest as
    :func:`attention_bwd_ref`."""
    return _bwd_ref(q, k, v, bias_kv, g, num_heads, drop=_drop(q, k, num_heads, rate, seed))


# ---------------------------------------------------------------------------
# Kernel wrappers (ctypes; see ops/_build.py).
# ---------------------------------------------------------------------------

_P, _I, _LL, _F, _U64 = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_ulonglong
)
_DROP_ARGS = [_U64, _I, _F]  # seed, threshold, keep scale


@functools.lru_cache(maxsize=None)
def _entry(source: str, symbol: str, n_pointers: int, dropout: bool):
    """The C entry ``symbol`` of ``csrc/<source>.cu``:
    (pointers..., dtype, batch, sq, skv, heads, dim, six strides, scale,
    [seed, threshold, keep_scale], stream) -> cudaError_t."""
    lib = load_library(source)
    fn = getattr(lib, symbol)
    fn.argtypes = (
        [_P] * n_pointers + [_I] * 6 + [_LL] * 6 + [_F]
        + (_DROP_ARGS if dropout else []) + [_P]
    )
    fn.restype = _I
    lib.rgqa_cuda_error_string.argtypes = [_I]
    lib.rgqa_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.rgqa_cuda_error_string


def _check_lengths(name: str, sq: int, skv: int, d: int, *, long: bool) -> None:
    """Raise ``ValueError`` for lengths the short kernels (or, ``long``,
    the long-stream forward and backward, which take any Sq and Skv) do
    not take, saying why."""
    if (not long and (sq > MAX_SEQ or skv > MAX_SEQ)) or d > MAX_HEAD_DIM:
        limits = "any Sq and Skv" if long else f"Sq, Skv <= {MAX_SEQ}"
        raise ValueError(
            f"{name}: Sq={sq}, Skv={skv}, D={d} exceed the kernel's limits "
            f"({limits}, head dim <= {MAX_HEAD_DIM})"
        )


def forward_kernel(sq: int, skv: int, head_dim: int):
    """The forward kernel's wrapper for an (Sq, Skv) call with heads
    ``head_dim`` wide: :func:`fused_attention_cuda` (#1) when both
    lengths are <= MAX_SEQ, :func:`fused_attention_long_cuda` (#2) for
    longer streams, at any length.  Raises ``ValueError`` for heads wider
    than MAX_HEAD_DIM."""
    long = sq > MAX_SEQ or skv > MAX_SEQ
    _check_lengths("fused_attention", sq, skv, head_dim, long=long)
    return fused_attention_long_cuda if long else fused_attention_cuda


def backward_kernel(sq: int, skv: int, head_dim: int):
    """The backward kernel's wrapper, chosen as :func:`forward_kernel`
    chooses: :func:`fused_attention_bwd_cuda` (#3) when both lengths are
    <= MAX_SEQ, :func:`fused_attention_long_bwd_cuda` (#3L) for longer
    streams, at any length (it takes the forward's ``lse``).  Raises
    ``ValueError`` for heads wider than MAX_HEAD_DIM."""
    long = sq > MAX_SEQ or skv > MAX_SEQ
    _check_lengths("the attention backward", sq, skv, head_dim, long=long)
    return fused_attention_long_bwd_cuda if long else fused_attention_bwd_cuda


def dropout_forward_kernel(sq: int, skv: int, head_dim: int):
    """The dropout forward's wrapper, chosen as :func:`forward_kernel`
    chooses: :func:`fused_attention_dropout_cuda` (#4) when both lengths
    are <= MAX_SEQ, :func:`fused_attention_dropout_long_cuda` (4L) for
    longer streams, at any length."""
    long = sq > MAX_SEQ or skv > MAX_SEQ
    _check_lengths("fused_attention_dropout", sq, skv, head_dim, long=long)
    return fused_attention_dropout_long_cuda if long else fused_attention_dropout_cuda


def dropout_backward_kernel(sq: int, skv: int, head_dim: int):
    """The dropout backward's wrapper: :func:`fused_attention_dropout_bwd_cuda`
    (#5) when both lengths are <= MAX_SEQ,
    :func:`fused_attention_dropout_long_bwd_cuda` (5L, which takes the
    forward's ``lse``) for longer streams."""
    long = sq > MAX_SEQ or skv > MAX_SEQ
    _check_lengths("the attention dropout backward", sq, skv, head_dim, long=long)
    return fused_attention_dropout_long_bwd_cuda if long else fused_attention_dropout_bwd_cuda


def _check(name, q, k, v, bias_kv, num_heads: int, g=None, *, long: bool = False) -> None:
    """Raise on anything the kernels do not take (``long``: the long
    forward's limits)."""
    tensors = {"q": q, "k": k, "v": v}
    for tname, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {tname} is on {t.device}, not CUDA")
        if t.device != q.device:
            raise ValueError(f"{name}: q, k, v on different devices")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(
                f"{name}: {tname} has dtype {t.dtype}; the kernel takes float32 or bfloat16"
            )
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: q, k, v differ in dtype")
        if t.dim() != 3:
            raise ValueError(f"{name}: {tname} must be (B, S, E), got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {tname}'s last dim must be contiguous")
    b, sq, e = q.shape
    skv = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != e:
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not agree"
        )
    if e % num_heads:
        raise ValueError(f"{name}: width {e} not divisible by {num_heads} heads")
    _check_lengths(name, sq, skv, e // num_heads, long=long)
    if (
        bias_kv.device != q.device
        or bias_kv.dtype != torch.float32
        or tuple(bias_kv.shape) != (b, skv)
        or not bias_kv.is_contiguous()
    ):
        raise ValueError(
            f"{name}: bias must be a contiguous (B, Skv) float32 tensor on "
            f"{q.device}, got {tuple(bias_kv.shape)} {bias_kv.dtype} on {bias_kv.device}"
        )
    if g is not None and (
        g.device != q.device or g.dtype != q.dtype or g.shape != q.shape
        or not g.is_contiguous()
    ):
        raise ValueError(
            f"{name}: g must be a contiguous {tuple(q.shape)} {q.dtype} tensor on "
            f"{q.device}, got {tuple(g.shape)} {g.dtype} on {g.device}"
        )


def _dropout_args(name: str, rate: float, seed: int) -> list:
    t, keep_p = keep_threshold(rate)
    if t >= 256:
        raise ValueError(f"{name}: rate {rate} rounds to 256/256; nothing would be kept")
    if not 0 <= int(seed) < 2**64:
        raise ValueError(f"{name}: seed {seed} is not a 64-bit unsigned integer")
    return [int(seed), t, 1.0 / keep_p]


def _launch(name, source, symbol, pointers, q, k, v, num_heads, drop=None) -> None:
    b, sq, e = q.shape
    d = e // num_heads
    with torch.cuda.device(q.device):
        fn, errstr = _entry(source, symbol, len(pointers), drop is not None)
        err = fn(
            *pointers, _DTYPE_CODE[q.dtype], b, sq, k.shape[1], num_heads, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), 1.0 / math.sqrt(d), *(drop or []),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed ({err}): {errstr(err).decode()}")


def fused_attention_cuda(q, k, v, bias_kv, num_heads: int) -> torch.Tensor:
    """Launch ``csrc/fused_attention.cu`` on the current stream.

    ``q`` (B, Sq, E), ``k``/``v`` (B, Skv, E) may be strided views (e.g.
    slices of the fused QKV projection) as long as their last dim is
    contiguous; ``bias_kv`` is the (B, Skv) f32 additive mask.  Returns a
    new contiguous (B, Sq, E) tensor.  ``fused_attention_cuda.launches``
    counts the launches."""
    _check("fused_attention_cuda", q, k, v, bias_kv, num_heads)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(
        "fused_attention", "fused_attention", "rgqa_fused_attention_fwd",
        [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_kv.data_ptr(), out.data_ptr()],
        q, k, v, num_heads,
    )
    fused_attention_cuda.launches += 1
    return out


def fused_attention_long_cuda(q, k, v, bias_kv, num_heads: int, *, lse: bool = False):
    """Launch ``csrc/fused_attention_long.cu`` on the current stream: the
    function of :func:`fused_attention_cuda` for any Sq and Skv (query
    tiles of 64 rows, an online softmax over key tiles of 64; in f32 each
    row's complete softmax up to 256 keys).  The same
    arguments and result; with ``lse=True`` it returns ``(out, lse)``,
    ``lse`` the (B, H, Sq, 2) f32 statistics ``(m, log(sum))`` of each
    row's scores, their max and the log of their softmax sum, whose sum is
    the row's log-sum-exp, which :func:`fused_attention_long_bwd_cuda`
    takes (two parts: a fully masked row's scores lie near -1e4, where one
    f32 keeps the log-sum-exp only to 2^-10); ``out`` is the same either
    way.  ``fused_attention_long_cuda.launches`` counts the launches."""
    _check("fused_attention_long_cuda", q, k, v, bias_kv, num_heads, long=True)
    result = _long_fwd("fused_attention_long", "rgqa_fused_attention_long_fwd", q, k, v, bias_kv, num_heads, lse)
    fused_attention_long_cuda.launches += 1
    return result


def _long_fwd(name, symbol, q, k, v, bias_kv, num_heads: int, lse: bool, drop=None):
    """Launch ``symbol`` of ``csrc/fused_attention_long.cu`` (#2, or 4L
    with ``drop``); ``out``, or ``(out, lse)`` with the row statistics."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    stats = (
        torch.empty((q.shape[0], num_heads, q.shape[1], 2), dtype=torch.float32, device=q.device)
        if lse else None
    )
    _launch(
        name, "fused_attention_long", symbol,
        [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_kv.data_ptr(), out.data_ptr(),
         None if stats is None else stats.data_ptr()],
        q, k, v, num_heads, drop,
    )
    return (out, stats) if lse else out


def _bwd_buffers(q, k, num_heads: int):
    b, skv = k.shape[:2]
    return (
        torch.empty(q.shape, dtype=q.dtype, device=q.device),
        torch.empty(k.shape, dtype=k.dtype, device=q.device),
        torch.empty(k.shape, dtype=k.dtype, device=q.device),
        # dbias partials, then their (B, Skv) sum in order: (B, H, Skv) per
        # head (f32 and long bodies), (B, ceil(H / 2), Skv) per head pair
        # (short bf16 body), in the same scratch
        torch.empty((b, num_heads, skv), dtype=torch.float32, device=q.device),
        torch.empty((b, skv), dtype=torch.float32, device=q.device),
    )


def _bwd_pointers(q, k, v, bias_kv, g, buffers):
    return [t.data_ptr() for t in (q, k, v, bias_kv, g, *buffers)]


def fused_attention_bwd_cuda(q, k, v, bias_kv, g, num_heads: int):
    """Launch ``csrc/fused_attention_bwd.cu``: (dq, dk, dv, dbias) of
    :func:`fused_attention_cuda` for the output gradient ``g``
    (contiguous, the input dtype).  dq, dk, dv come out contiguous in the
    input dtype, dbias as (B, Skv) f32, summed over heads in a fixed
    order (no atomics: two runs give identical gradients).
    ``fused_attention_bwd_cuda.launches`` counts the launches."""
    _check("fused_attention_bwd_cuda", q, k, v, bias_kv, num_heads, g=g)
    buffers = _bwd_buffers(q, k, num_heads)
    _launch(
        "fused_attention_bwd", "fused_attention_bwd", "rgqa_fused_attention_bwd",
        _bwd_pointers(q, k, v, bias_kv, g, buffers), q, k, v, num_heads,
    )
    fused_attention_bwd_cuda.launches += 1
    dq, dk, dv, _, dbias = buffers
    return dq, dk, dv, dbias


def _long_bwd(name, symbol, q, k, v, bias_kv, g, num_heads: int, lse, drop=None, *, dbias=True, out=None):
    """Check ``lse`` (and, without ``dbias``, ``out``) and launch ``symbol``
    of ``csrc/fused_attention_long_bwd.cu`` (#3L, or 5L with ``drop``);
    (dq, dk, dv, dbias), dbias None without ``dbias``."""
    want = (q.shape[0], num_heads, q.shape[1])
    if (
        lse.device != q.device or lse.dtype != torch.float32
        or tuple(lse.shape) != (*want, 2) or not lse.is_contiguous()
    ):
        raise ValueError(
            f"{name}: lse must be the forward's contiguous {(*want, 2)} float32 tensor on "
            f"{q.device}, got {tuple(lse.shape)} {lse.dtype} on {lse.device}"
        )
    if dbias and out is not None:
        raise ValueError(f"{name}: out is taken only with dbias=False (D from the forward's output)")
    if not dbias and (
        out is None or out.device != q.device or out.dtype != q.dtype or out.shape != q.shape
        or not out.is_contiguous()
    ):
        got = "None" if out is None else f"{tuple(out.shape)} {out.dtype} on {out.device}"
        raise ValueError(
            f"{name}: dbias=False takes the forward's output, a contiguous {tuple(q.shape)} "
            f"{q.dtype} tensor on {q.device}, as out; got {got}"
        )
    buffers = _bwd_buffers(q, k, num_heads)
    # (B, H, Sq, 2) f32: each row's D = rowsum(dP P) and -(m + log(sum))
    # log2(e), which the dQ pass hands the dK/dV pass.
    dsum = torch.empty((*want, 2), dtype=torch.float32, device=q.device)
    _launch(
        name.removesuffix("_cuda"), "fused_attention_long_bwd", symbol,
        _bwd_pointers(q, k, v, bias_kv, g, buffers)
        + [lse.data_ptr(), dsum.data_ptr(), None if dbias else out.data_ptr()],
        q, k, v, num_heads, drop,
    )
    dq, dk, dv, _, dbias_sum = buffers
    return dq, dk, dv, dbias_sum if dbias else None


def fused_attention_long_bwd_cuda(q, k, v, bias_kv, g, num_heads: int, lse, *, dbias: bool = True, out=None):
    """Launch ``csrc/fused_attention_long_bwd.cu``: the function of
    :func:`fused_attention_bwd_cuda` for any Sq and Skv, given ``lse``,
    the (B, H, Sq, 2) f32 row statistics of the forward
    (``fused_attention_long_cuda(..., lse=True)``).  A pass over query
    tiles walks the key tiles for dq, a pass over key tiles walks the
    query tiles for dk and dv; both need each row's D = rowsum(dP P).
    With ``dbias`` (the default) the first pass takes D in a sweep of
    its own, the second writes the dbias partials, then their head sum.
    With ``dbias=False`` it takes ``out``, the forward's output: in bf16
    the first pass takes D = rowsum(g o out) and no sweep, no dbias is
    written, and the fourth result is None (the f32 passes keep their
    sweep).  No atomics, so two runs give identical gradients.
    ``fused_attention_long_bwd_cuda.launches`` counts the launches."""
    name = "fused_attention_long_bwd_cuda"
    _check(name, q, k, v, bias_kv, num_heads, g=g, long=True)
    grads = _long_bwd(name, "rgqa_fused_attention_long_bwd", q, k, v, bias_kv, g, num_heads, lse,
                      dbias=dbias, out=out)
    fused_attention_long_bwd_cuda.launches += 1
    return grads


def fused_attention_dropout_cuda(q, k, v, bias_kv, num_heads: int, rate: float, seed: int):
    """Launch the forward of ``csrc/fused_attention_dropout.cu``:
    :func:`fused_attention_cuda` with the keep mask of
    :func:`dropout_keep_mask_ref` on P.
    ``fused_attention_dropout_cuda.launches`` counts the launches."""
    name = "fused_attention_dropout_cuda"
    _check(name, q, k, v, bias_kv, num_heads)
    drop = _dropout_args(name, rate, seed)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(
        "fused_attention_dropout", "fused_attention_dropout", "rgqa_fused_attention_dropout_fwd",
        [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_kv.data_ptr(), out.data_ptr()],
        q, k, v, num_heads, drop,
    )
    fused_attention_dropout_cuda.launches += 1
    return out


def fused_attention_dropout_bwd_cuda(q, k, v, bias_kv, g, num_heads: int, rate: float, seed: int):
    """Launch the backward of ``csrc/fused_attention_dropout.cu``, which
    replays the forward's mask from ``seed``: (dq, dk, dv, dbias) as
    :func:`fused_attention_bwd_cuda` returns them.
    ``fused_attention_dropout_bwd_cuda.launches`` counts the launches."""
    name = "fused_attention_dropout_bwd_cuda"
    _check(name, q, k, v, bias_kv, num_heads, g=g)
    drop = _dropout_args(name, rate, seed)
    buffers = _bwd_buffers(q, k, num_heads)
    _launch(
        "fused_attention_dropout_bwd", "fused_attention_dropout",
        "rgqa_fused_attention_dropout_bwd",
        _bwd_pointers(q, k, v, bias_kv, g, buffers), q, k, v, num_heads, drop,
    )
    fused_attention_dropout_bwd_cuda.launches += 1
    dq, dk, dv, _, dbias = buffers
    return dq, dk, dv, dbias


def fused_attention_dropout_long_cuda(
    q, k, v, bias_kv, num_heads: int, rate: float, seed: int, *, lse: bool = False
):
    """4L: launch the dropout forward of ``csrc/fused_attention_long.cu``,
    :func:`fused_attention_long_cuda` with the keep mask of
    :func:`dropout_keep_mask_ref` on P, at any Sq and Skv.  With
    ``lse=True`` it returns ``(out, lse)``, the statistics of the
    undropped scores, which :func:`fused_attention_dropout_long_bwd_cuda`
    takes.  ``fused_attention_dropout_long_cuda.launches`` counts the
    launches."""
    name = "fused_attention_dropout_long_cuda"
    _check(name, q, k, v, bias_kv, num_heads, long=True)
    result = _long_fwd(name.removesuffix("_cuda"), "rgqa_fused_attention_dropout_long_fwd", q, k, v, bias_kv,
                       num_heads, lse, _dropout_args(name, rate, seed))
    fused_attention_dropout_long_cuda.launches += 1
    return result


def fused_attention_dropout_long_bwd_cuda(
    q, k, v, bias_kv, g, num_heads: int, rate: float, seed: int, lse, *, dbias: bool = True, out=None
):
    """5L: launch the dropout backward of ``csrc/fused_attention_long_bwd.cu``,
    which replays 4L's mask from ``seed`` in both passes, given 4L's
    ``lse``: (dq, dk, dv, dbias) as :func:`fused_attention_dropout_bwd_cuda`
    returns them, at any Sq and Skv; ``dbias`` and ``out`` (4L's dropped
    output) as :func:`fused_attention_long_bwd_cuda` takes them.
    ``fused_attention_dropout_long_bwd_cuda.launches`` counts the launches."""
    name = "fused_attention_dropout_long_bwd_cuda"
    _check(name, q, k, v, bias_kv, num_heads, g=g, long=True)
    drop = _dropout_args(name, rate, seed)
    grads = _long_bwd(
        name, "rgqa_fused_attention_dropout_long_bwd", q, k, v, bias_kv, g, num_heads, lse, drop,
        dbias=dbias, out=out,
    )
    fused_attention_dropout_long_bwd_cuda.launches += 1
    return grads


for _wrapper in (
    fused_attention_cuda, fused_attention_long_cuda, fused_attention_bwd_cuda,
    fused_attention_long_bwd_cuda, fused_attention_dropout_cuda, fused_attention_dropout_bwd_cuda,
    fused_attention_dropout_long_cuda, fused_attention_dropout_long_bwd_cuda,
):
    _wrapper.launches = 0


# ---------------------------------------------------------------------------
# Differentiable entry points.
# ---------------------------------------------------------------------------


def _save_long(ctx, inputs, out, lse) -> None:
    """What the long route's backward keeps: the inputs, the row
    statistics and, when the bias takes no gradient (every model path:
    ``bias_vector``'s mask), the output, from which the kernel takes D
    without a sweep (the tensor that the out-projection keeps anyway)."""
    ctx.long, ctx.dbias = True, ctx.needs_input_grad[3]
    ctx.save_for_backward(*inputs, lse, *(() if ctx.dbias else (out,)))


def _long_grads(ctx, kernel, g, *args):
    """The long backward ``kernel`` on the saved tensors: the exact route
    (dbias) or D from the saved output (dbias None)."""
    q, k, v, bias_kv, lse, *out = ctx.saved_tensors
    return kernel(q, k, v, bias_kv, g, *args, lse, dbias=ctx.dbias, out=out[0] if out else None)


class _FusedAttention(torch.autograd.Function):
    """``_fused``'s custom_vjp: on CUDA kernels #1 forward and #3 backward
    (Sq, Skv <= 64) or #2 and #3L (longer streams), the plain pair on the
    CPU.  On the long route the forward also writes each row's softmax
    statistics, and saves them for #3L, when an input needs a gradient
    (``ctx.needs_input_grad``: inside ``forward`` autograd is off, so
    ``torch.is_grad_enabled()`` says nothing); inference writes none.
    When the bias takes no gradient #3L takes D from the saved output and
    returns None for the bias (``dbias=False``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias_kv, num_heads):
        ctx.num_heads = num_heads
        ctx.long = False
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, bias_kv)
            return attention_natural_ref(q, k, v, bias_kv, num_heads)
        kernel = forward_kernel(q.shape[1], k.shape[1], q.shape[2] // num_heads)
        if kernel is fused_attention_long_cuda and any(ctx.needs_input_grad[:4]):
            out, lse = kernel(q, k, v, bias_kv, num_heads, lse=True)
            _save_long(ctx, (q, k, v, bias_kv), out, lse)
            return out
        ctx.save_for_backward(q, k, v, bias_kv)
        return kernel(q, k, v, bias_kv, num_heads)

    @staticmethod
    def backward(ctx, g):
        g = g.to(ctx.saved_tensors[0].dtype).contiguous()
        if ctx.long:
            grads = _long_grads(ctx, fused_attention_long_bwd_cuda, g, ctx.num_heads)
        else:
            q, k, v, bias_kv = ctx.saved_tensors
            if q.device.type == "cpu":
                grads = attention_bwd_ref(q, k, v, bias_kv, g, ctx.num_heads)
            else:
                kernel = backward_kernel(q.shape[1], k.shape[1], q.shape[2] // ctx.num_heads)
                grads = kernel(q, k, v, bias_kv, g, ctx.num_heads)
        return (*grads, None)


class _FusedAttentionDropout(torch.autograd.Function):
    """``_fused_drop``'s custom_vjp: on CUDA kernels #4 / #5 (Sq, Skv <=
    64) or 4L / 5L (longer streams), the plain pair on the CPU; the
    backward replays the mask from the saved seed.  On the long route the
    forward writes and saves the row statistics for 5L only when an input
    needs a gradient, as :class:`_FusedAttention` does (MC-dropout
    scoring writes none), and 5L takes D from 4L's saved output when the
    bias takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias_kv, num_heads, rate, seed):
        ctx.args = (num_heads, rate, seed)
        ctx.long = False
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, bias_kv)
            return attention_dropout_ref(q, k, v, bias_kv, num_heads, rate, seed)
        kernel = dropout_forward_kernel(q.shape[1], k.shape[1], q.shape[2] // num_heads)
        if kernel is fused_attention_dropout_long_cuda and any(ctx.needs_input_grad[:4]):
            out, lse = kernel(q, k, v, bias_kv, num_heads, rate, seed, lse=True)
            _save_long(ctx, (q, k, v, bias_kv), out, lse)
            return out
        ctx.save_for_backward(q, k, v, bias_kv)
        return kernel(q, k, v, bias_kv, num_heads, rate, seed)

    @staticmethod
    def backward(ctx, g):
        g = g.to(ctx.saved_tensors[0].dtype).contiguous()
        if ctx.long:
            grads = _long_grads(ctx, fused_attention_dropout_long_bwd_cuda, g, *ctx.args)
        else:
            q, k, v, bias_kv = ctx.saved_tensors
            if q.device.type == "cpu":
                grads = attention_dropout_bwd_ref(q, k, v, bias_kv, g, *ctx.args)
            else:
                kernel = dropout_backward_kernel(q.shape[1], k.shape[1], q.shape[2] // ctx.args[0])
                grads = kernel(q, k, v, bias_kv, g, *ctx.args)
        return (*grads, None, None, None)


def fused_attention(
    q, k, v, bias=None, *, num_heads: int, force_xla: bool = False
) -> torch.Tensor:
    """Attention on the natural (B, S, H*D) layout, differentiable.

    ``bias`` is an additive float mask, ``(B, S_kv)`` or ``(B, 1, 1,
    S_kv)``; None means fully visible.  CUDA tensors go to kernels #1
    forward and #3 backward or, for streams longer than 64, #2 and #3L,
    CPU tensors to their plain versions; ``force_xla=True`` runs
    :func:`attention_natural_ref` under PyTorch's autograd."""
    bias_kv = bias_vector(bias, q.shape[0], k.shape[1], device=q.device)
    if force_xla:
        return attention_natural_ref(q, k, v, bias_kv, num_heads)
    return _FusedAttention.apply(q, k, v, bias_kv, num_heads)


def fused_attention_dropout(
    q, k, v, bias=None, *, num_heads: int, rate: float, seed: int,
    force_xla: bool = False,
) -> torch.Tensor:
    """:func:`fused_attention` with attention-probability dropout at
    ``rate`` (quantized to 1/256), its mask a pure function of ``seed``
    and the element.  CUDA tensors go to kernels #4 and #5 (Sq, Skv <=
    64) or 4L and 5L (longer streams), CPU tensors to their plain
    versions; ``force_xla=True`` runs :func:`attention_dropout_ref` under
    PyTorch's autograd."""
    bias_kv = bias_vector(bias, q.shape[0], k.shape[1], device=q.device)
    if force_xla:
        return attention_dropout_ref(q, k, v, bias_kv, num_heads, float(rate), int(seed))
    return _FusedAttentionDropout.apply(q, k, v, bias_kv, num_heads, float(rate), int(seed))
