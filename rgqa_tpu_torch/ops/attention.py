"""Multi-head attention on the natural (B, S, H*D) layout.

Port of ``rgqa_tpu/ops/attention.py``'s inference forward:

- :func:`attention_natural_ref` is the plain PyTorch version, the
  counterpart of ``_attention_natural_xla``: f32 scores and softmax, the
  PV product in f32, the result cast back to the input dtype;
- :func:`fused_attention_cuda` launches the hand-written Hopper kernel
  ``csrc/fused_attention.cu``, the counterpart of the Pallas
  ``_fused_kernel`` (P rounded to the input dtype before PV);
- :func:`fused_attention` dispatches: the plain version for tensors on
  the CPU or under ``force_xla``, the kernel for everything else.  A
  CUDA tensor reaches the kernel or raises; there is no fallback.

The TPU kernel's VMEM block ladder (``_fit_block``, ``_fwd_plan``) has no
counterpart: one thread block per (batch row, head) holds its whole
problem in shared memory.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from rgqa_tpu_torch.ops._build import load_library

__all__ = [
    "MAX_SEQ",
    "MAX_HEAD_DIM",
    "bias_vector",
    "attention_natural_ref",
    "fused_attention",
    "fused_attention_cuda",
]

# The kernel's limits (csrc/fused_attention.cu kMaxSeq / kMaxDim).
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


def attention_natural_ref(q, k, v, bias_kv, num_heads: int) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d) + bias) v`` per head, plain PyTorch
    (``_attention_natural_xla``): scores cast to f32, f32 softmax, PV in
    f32, output in the input dtype."""
    b, sq, e = q.shape
    skv = k.shape[1]
    d = e // num_heads
    qh = q.reshape(b, sq, num_heads, d)
    kh = k.reshape(b, skv, num_heads, d)
    vh = v.reshape(b, skv, num_heads, d)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(d)
    scores = scores.to(torch.float32) + bias_kv[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vh.to(torch.float32))
    return out.reshape(b, sq, e).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = load_library("fused_attention")
    fn = lib.rgqa_fused_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 5          # q, k, v, bias, out
        + [ctypes.c_int] * 6           # dtype, batch, sq, skv, heads, dim
        + [ctypes.c_longlong] * 6      # q/k/v batch and row strides
        + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
    )
    fn.restype = ctypes.c_int
    lib.rgqa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rgqa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, bias_kv, num_heads: int) -> None:
    """Raise on anything the kernel does not take."""
    tensors = {"q": q, "k": k, "v": v}
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"fused_attention_cuda: {name} is on {t.device}, not CUDA")
        if t.device != q.device:
            raise ValueError("fused_attention_cuda: q, k, v on different devices")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(
                f"fused_attention_cuda: {name} has dtype {t.dtype}; the kernel "
                "takes float32 or bfloat16"
            )
        if t.dtype != q.dtype:
            raise TypeError("fused_attention_cuda: q, k, v differ in dtype")
        if t.dim() != 3:
            raise ValueError(f"fused_attention_cuda: {name} must be (B, S, E), got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"fused_attention_cuda: {name}'s last dim must be contiguous")
    b, sq, e = q.shape
    skv = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != e:
        raise ValueError(
            f"fused_attention_cuda: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not agree"
        )
    if e % num_heads:
        raise ValueError(f"fused_attention_cuda: width {e} not divisible by {num_heads} heads")
    d = e // num_heads
    if sq > MAX_SEQ or skv > MAX_SEQ or d > MAX_HEAD_DIM:
        raise ValueError(
            f"fused_attention_cuda: Sq={sq}, Skv={skv}, D={d} exceed the kernel's "
            f"limits (sequences <= {MAX_SEQ}, head dim <= {MAX_HEAD_DIM})"
        )
    if (
        bias_kv.device != q.device
        or bias_kv.dtype != torch.float32
        or tuple(bias_kv.shape) != (b, skv)
        or not bias_kv.is_contiguous()
    ):
        raise ValueError(
            "fused_attention_cuda: bias must be a contiguous (B, Skv) float32 "
            f"tensor on {q.device}, got {tuple(bias_kv.shape)} {bias_kv.dtype} "
            f"on {bias_kv.device}"
        )


def fused_attention_cuda(q, k, v, bias_kv, num_heads: int) -> torch.Tensor:
    """Launch ``csrc/fused_attention.cu`` on the current stream.

    ``q`` (B, Sq, E), ``k``/``v`` (B, Skv, E) may be strided views (e.g.
    slices of the fused QKV projection) as long as their last dim is
    contiguous; ``bias_kv`` is the (B, Skv) f32 additive mask.  Returns a
    new contiguous (B, Sq, E) tensor.  ``fused_attention_cuda.launches``
    counts the launches."""
    _check(q, k, v, bias_kv, num_heads)
    b, sq, e = q.shape
    skv = k.shape[1]
    d = e // num_heads
    out = torch.empty((b, sq, e), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        lib = _kernel()
        err = lib.rgqa_fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_kv.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[q.dtype], b, sq, skv, num_heads, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        msg = lib.rgqa_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_attention kernel launch failed ({err}): {msg}")
    fused_attention_cuda.launches += 1
    return out


fused_attention_cuda.launches = 0


def fused_attention(
    q, k, v, bias=None, *, num_heads: int, force_xla: bool = False
) -> torch.Tensor:
    """Attention on the natural (B, S, H*D) layout.

    ``bias`` is an additive float mask, ``(B, S_kv)`` or ``(B, 1, 1,
    S_kv)``; None means fully visible.  Tensors on the CPU, or
    ``force_xla=True``, take :func:`attention_natural_ref`; every other
    tensor goes to the CUDA kernel, which raises on what it cannot take."""
    bias_kv = bias_vector(bias, q.shape[0], k.shape[1], device=q.device)
    if force_xla or q.device.type == "cpu":
        return attention_natural_ref(q, k, v, bias_kv, num_heads)
    return fused_attention_cuda(q, k, v, bias_kv, num_heads)
