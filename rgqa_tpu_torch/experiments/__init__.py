"""The JAX package's kernel experiments, ported: each asks a question of a
fused-attention design, and here asks it of the H100.

| entry point | kernel (wrapper) | source | TPU kernel it replaces | plain version |
| --- | --- | --- | --- | --- |
| ``python -m rgqa_tpu_torch.experiments.xfuse_exp`` | :func:`~.xfuse_exp.dual_pair_cuda` | ``csrc/xfuse.cu`` | ``_dual_kernel`` (``experiments/xfuse_exp.py``) | :func:`~.xfuse_exp.dual_pair_ref` |
| | :func:`~.xfuse_exp.cat_call_cuda` | ``csrc/xfuse.cu`` | ``_cat_kernel`` | :func:`~.xfuse_exp.cat_call_ref` |
| ``python -m rgqa_tpu_torch.experiments.headfold_exp`` | :func:`~.headfold_exp.headfold_cuda` | ``csrc/headfold.cu`` | ``_concat_kernel`` and ``_scratch_kernel`` (``experiments/headfold_exp.py``) | :func:`~.headfold_exp.headfold_ref` |
| ``python -m rgqa_tpu_torch.experiments.epilogue_exp`` | :func:`~.epilogue_exp.epi_fused_cuda` | ``csrc/epilogue.cu`` | ``_epi_kernel`` (``experiments/epilogue_exp.py``) | :func:`~.epilogue_exp.epi_fused_ref` |

Each entry point runs on the card unless given ``--device cpu``, takes
``--batch`` (default 384) and ``--iters``, and prints one row per variant:
the time per call in us (CUDA events), its ratio to the shipped form,
and the largest difference from the plain version.  On the CPU it runs
the plain versions only: no time is printed, and the difference is taken
against the shipped form's plain version.  Its last line is the launch
counts of its kernels.  Each kernel's wrapper (``*_cuda``) launches on
CUDA tensors or raises, and counts its launches in ``.launches``; the
public function (``dual_pair``, ``cat_call``, ``headfold``,
``epi_fused``) takes the plain version for CPU tensors only.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import math
import sys
from pathlib import Path

import torch

from rgqa_tpu_torch.device import resolve_device
from rgqa_tpu_torch.ops._build import load_library
from rgqa_tpu_torch.ops.attention import _DTYPE_CODE

__all__ = ["H", "E", "D", "B", "attend_ref", "parse_args", "Table"]

H, E = 12, 768  # the experiments' heads and width (LXMERT's)
D = E // H
B = 384  # the TPU scripts' batch


def attend_ref(q, k, v, bias, num_heads: int, struct=None) -> torch.Tensor:
    """Each head's ``softmax(q_h k_h^T / sqrt(d) + bias [+ struct]) v_h``
    as the TPU experiments' bodies compute it (``_one_head_block``):
    products in f32, softmax in f32, P rounded to the input dtype before
    PV, the output in the input dtype.  ``bias`` is (B, Skv), ``struct``
    an optional (Sq, Skv) term."""
    b, sq, e = q.shape
    skv, d = k.shape[1], e // num_heads
    acc = torch.promote_types(q.dtype, torch.float32)
    qh, kh, vh = (t.reshape(b, -1, num_heads, d).to(acc) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (1.0 / math.sqrt(d)) + bias.to(acc)[:, None, None, :]
    if struct is not None:
        s = s + struct
    ex = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (ex / ex.sum(dim=-1, keepdim=True)).to(q.dtype).to(acc)
    return torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(b, sq, e).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel plumbing shared by the three modules (ctypes; see ops/_build.py).
# ---------------------------------------------------------------------------

P_, I_, LL_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.lru_cache(maxsize=None)
def bind(source: str, symbol: str, argtypes: tuple):
    """The C entry ``symbol`` of ``csrc/<source>.cu`` (built at first use)
    with its argument types, and the library's error-string function."""
    lib = load_library(source)
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = I_
    lib.rgqa_cuda_error_string.argtypes = [I_]
    lib.rgqa_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.rgqa_cuda_error_string


def call(name: str, source: str, symbol: str, argtypes: tuple, device, *args) -> None:
    """Launch on ``device``'s current stream (appended as the last
    argument); raise ``RuntimeError`` if the launch fails."""
    with torch.cuda.device(device):
        fn, errstr = bind(source, symbol, argtypes)
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed ({err}): {errstr(err).decode()}")


def dtype_code(t: torch.Tensor) -> int:
    return _DTYPE_CODE[t.dtype]


def strides(*tensors) -> list:
    """(batch, row) element strides of each (B, S, E) tensor."""
    return [s for t in tensors for s in (t.stride(0), t.stride(1))]


def check_vector(name: str, what: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``shape`` tensor of ``dtype`` on
    ``device``."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: {what} must be a contiguous {shape} {dtype} tensor on {device}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device}"
        )


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def parse_args(argv, description: str):
    """``--device`` (default: the card), ``--batch`` and ``--iters``; the
    device resolved (raises without a card unless ``--device cpu``)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default) or the CPU, which runs the plain versions only")
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--iters", type=int, default=50, help="launches per timing (CUDA events)")
    args = ap.parse_args(argv)
    return args, resolve_device(args.device)


def _cuda_ms():
    """``chip_smoke.cuda_ms`` of the checkout this package lies in."""
    root = str(Path(__file__).resolve().parents[2])
    if root not in sys.path:
        sys.path.insert(0, root)
    from chip_smoke import cuda_ms

    return cuda_ms


class Table:
    """The rows an entry point prints: per variant, the time per call
    (card only), its ratio to the shipped form, and max |d| from its
    reference."""

    def __init__(self, device, iters: int):
        self.device, self.iters = device, iters
        self.rows = []

    def time_us(self, fn):
        if self.device.type != "cuda":
            return None
        return _cuda_ms()(fn, iters=self.iters, warmup=min(5, self.iters)) * 1e3

    def row(self, label: str, us, shipped_us, err: float) -> dict:
        row = {"variant": label, "us": us, "ratio": None if us is None or shipped_us is None else shipped_us / us,
               "max_abs_diff": err}
        self.rows.append(row)
        t = "not timed (CPU)" if us is None else f"{us:9.1f} us, shipped / this {row['ratio']:.2f}"
        print(f"{label:36s} {t}  max|d| {err:.3e}", flush=True)
        return row


def max_diff(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_diff(x, y) for x, y in zip(a, b))
    return (a.float() - b.float()).abs().max().item()


def print_launches(wrappers) -> dict:
    """Print, as the last line, ``launches {json}`` of each kernel wrapper."""
    counts = {w.__name__.removesuffix("_cuda"): w.launches for w in wrappers}
    print("launches " + json.dumps(counts), flush=True)
    return counts


def describe(device) -> str:
    if device.type != "cuda":
        return "device: cpu (plain versions only)"
    return f"device: {torch.cuda.get_device_name(device)}"
