"""The paired cross-attention experiment on the H100: two attentions of an
LXMERT cross-modal layer in one launch.

    python -m rgqa_tpu_torch.experiments.xfuse_exp [--batch 384] [--iters 50] [--device cpu]

Port of ``experiments/xfuse_exp.py``.  Each cross-modal layer issues four
attention calls: the bidirectional cross pair (20x36 and 36x20, language
and vision) and the two self-attentions (20x20 and 36x36).  Two ways to
make one launch of a pair, timed against the shipped two calls of
kernel #1 (``pair``):

- ``dual``: :func:`dual_pair`, both problems in one grid (``csrc/xfuse.cu``,
  replacing ``_dual_kernel``);
- ``cat``: :func:`cat_call`, one attention over the concatenated 56-token
  stream with a structural term from the row and column indices
  (``xor``: only the other block's keys, the cross pair; ``diag``: only
  the own block's, the self pair; replacing ``_cat_kernel``).
  ``cat_e2e`` counts the concatenations of q, k, v and the bias and the
  split of the output; ``cat_pure`` takes the inputs already
  concatenated, as a model whose projections ran on the concatenated
  stream would.

The question on this card: does a launch saved, or two problems sharing
one grid, beat two launches, at batch 384 and at small batches where the
host bounds LXMERT (``--batch 32``)?  The TPU's answer (its docstring) is
that experiment's own history, not this one's target.
"""

from __future__ import annotations

import torch

from rgqa_tpu_torch import experiments as X
from rgqa_tpu_torch.ops import attention as att

__all__ = [
    "dual_pair", "dual_pair_ref", "dual_pair_cuda",
    "cat_call", "cat_call_ref", "cat_call_cuda", "cat_struct", "pair_problems", "MODES", "main",
]

MODES = {"xor": 0, "diag": 1}
SL, SV = 20, 36  # LXMERT's language and vision streams

_DUAL_ARGS = (
    (X.P_,) * 10 + (X.I_,) * 4 + (X.F_,)
    + ((X.I_,) * 2 + (X.LL_,) * 6) * 2 + (X.P_,)
)
_CAT_ARGS = (X.P_,) * 5 + (X.I_,) * 5 + (X.LL_,) * 6 + (X.F_, X.I_, X.I_, X.P_)


def dual_pair_ref(qa, ka, va, ma, qb, kb, vb, mb, num_heads: int = X.H):
    """The plain version of :func:`dual_pair_cuda`: two independent
    attentions, (oa, ob), each as the TPU body computes it
    (:func:`rgqa_tpu_torch.experiments.attend_ref`)."""
    return X.attend_ref(qa, ka, va, ma, num_heads), X.attend_ref(qb, kb, vb, mb, num_heads)


def cat_struct(s: int, split: int, mode: str, device=None) -> torch.Tensor:
    """The (S, S) f32 structural term of ``mode`` around ``split``: 0 where
    query row i may see key j, -1e9 elsewhere."""
    idx = torch.arange(s, device=device)
    row, col = (idx < split)[:, None], (idx < split)[None, :]
    allowed = (row != col) if mode == "xor" else (row == col)
    return torch.where(allowed, 0.0, -1e9).to(torch.float32)


def cat_call_ref(q, k, v, m, split: int, mode: str, num_heads: int = X.H):
    """The plain version of :func:`cat_call_cuda`: one attention over the
    (B, S, E) stream with the bias ``m`` (B, S) plus :func:`cat_struct`."""
    _check_mode(split, mode, q.shape[1])
    return X.attend_ref(q, k, v, m, num_heads, cat_struct(q.shape[1], split, mode, q.device))


def _check_mode(split: int, mode: str, s: int) -> None:
    if mode not in MODES or not 0 < split < s:
        raise ValueError(f"cat_call: mode {mode!r} must be one of {sorted(MODES)} and 0 < split {split} < S {s}")


def dual_pair_cuda(qa, ka, va, ma, qb, kb, vb, mb, num_heads: int = X.H):
    """Launch ``csrc/xfuse.cu``'s dual kernel: (oa, ob), new contiguous
    tensors.  Each problem's q, k, v may be strided views with a
    contiguous last dim, its bias a contiguous (B, Skv) f32 tensor; both
    problems on one device, of one dtype and batch, lengths <= 64.
    ``dual_pair_cuda.launches`` counts the launches."""
    name = "dual_pair_cuda"
    att._check(name, qa, ka, va, ma, num_heads)
    att._check(name, qb, kb, vb, mb, num_heads)
    if qb.device != qa.device or qb.dtype != qa.dtype or qb.shape[0] != qa.shape[0] or qb.shape[2] != qa.shape[2]:
        raise ValueError(f"{name}: the two problems differ in device, dtype, batch or width")
    oa = torch.empty(qa.shape, dtype=qa.dtype, device=qa.device)
    ob = torch.empty(qb.shape, dtype=qb.dtype, device=qb.device)
    b, _, e = qa.shape
    d = e // num_heads
    X.call(
        name, "xfuse", "rgqa_dual_pair", _DUAL_ARGS, qa.device,
        *(t.data_ptr() for t in (qa, ka, va, ma, oa, qb, kb, vb, mb, ob)),
        X.dtype_code(qa), b, num_heads, d, d ** -0.5,
        qa.shape[1], ka.shape[1], *X.strides(qa, ka, va),
        qb.shape[1], kb.shape[1], *X.strides(qb, kb, vb),
    )
    dual_pair_cuda.launches += 1
    return oa, ob


def cat_call_cuda(q, k, v, m, split: int, mode: str, num_heads: int = X.H):
    """Launch ``csrc/xfuse.cu``'s cat kernel on the (B, S, E) stream, S <=
    64, with the bias ``m`` (B, S) and the structural term of ``mode``
    around ``split`` computed in the kernel.  Returns a new contiguous
    (B, S, E) tensor; ``cat_call_cuda.launches`` counts the launches."""
    name = "cat_call_cuda"
    att._check(name, q, k, v, m, num_heads)
    s = q.shape[1]
    if k.shape[1] != s:
        raise ValueError(f"{name}: q has {s} rows and k {k.shape[1]}; the stream is one")
    _check_mode(split, mode, s)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    b, _, e = q.shape
    d = e // num_heads
    X.call(
        name, "xfuse", "rgqa_cat_call", _CAT_ARGS, q.device,
        *(t.data_ptr() for t in (q, k, v, m, out)),
        X.dtype_code(q), b, s, num_heads, d, *X.strides(q, k, v), d ** -0.5, split, MODES[mode],
    )
    cat_call_cuda.launches += 1
    return out


dual_pair_cuda.launches = 0
cat_call_cuda.launches = 0


def dual_pair(qa, ka, va, ma, qb, kb, vb, mb, num_heads: int = X.H):
    """Both attentions of a pair: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = dual_pair_ref if qa.device.type == "cpu" else dual_pair_cuda
    return fn(qa, ka, va, ma, qb, kb, vb, mb, num_heads)


def cat_call(q, k, v, m, split: int, mode: str, num_heads: int = X.H):
    """The concatenated-stream attention: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    fn = cat_call_ref if q.device.type == "cpu" else cat_call_cuda
    return fn(q, k, v, m, split, mode, num_heads)


# ---------------------------------------------------------------------------
# Entry point.
# ---------------------------------------------------------------------------


def make_inputs(b: int, device, dtype=torch.bfloat16, seed: int = 0):
    """The TPU script's inputs: normal q, k, v of the language and the
    vision stream, zero masks; ((ql, kl, vl, ml), (qv, kv, vv, mv))."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def stream(s):
        q, k, v = (torch.randn(b, s, X.E, generator=gen, device=device).to(dtype) for _ in range(3))
        return q, k, v, torch.zeros(b, s, device=device)

    return stream(SL), stream(SV)


def pair_problems(mode: str, lang, vis):
    """(problem a, problem b) of a pair, each (q, k, v, bias): ``xor``, the
    cross pair, the language queries on the vision keys and back;
    ``diag``, the self pair, each stream on itself.  Concatenated as
    [language; vision], either pair is :func:`cat_call` of that ``mode``
    split at the language length."""
    (ql, kl, vl, ml), (qv, kv, vv, mv) = lang, vis
    if mode == "xor":
        return (ql, kv, vv, mv), (qv, kl, vl, ml)
    return lang, vis


def main(argv=None) -> dict:
    args, device = X.parse_args(argv, __doc__.split("\n\n")[0])
    print(X.describe(device), f"batch {args.batch}, bf16" if device.type == "cuda" else "", flush=True)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    lang, vis = make_inputs(args.batch, device, dtype)
    table = X.Table(device, args.iters)
    shipped = att.fused_attention_cuda if device.type == "cuda" else att.attention_natural_ref
    concat = tuple(torch.cat(p, 1) for p in zip(lang, vis))  # the stream already concatenated

    checks = {}
    for label, mode in (("cross", "xor"), ("self", "diag")):
        pa, pb = pair_problems(mode, lang, vis)

        def cat_split(streams):
            o = cat_call(*streams, SL, mode)
            return o[:, :SL], o[:, SL:]

        forms = {
            "pair (shipped)": lambda: (shipped(*pa, X.H), shipped(*pb, X.H)),
            "dual": lambda: dual_pair(*pa, *pb),
            "cat_e2e": lambda: cat_split(tuple(torch.cat(p, 1) for p in zip(lang, vis))),
            "cat_pure": lambda: cat_split(concat),
        }
        outs = {name: fn() for name, fn in forms.items()}
        # Every form computes this pair: on the card each is held to the
        # plain version, on the CPU each plain form to the shipped one's.
        plain = dual_pair_ref(*pa, *pb) if device.type == "cuda" else outs["pair (shipped)"]
        base_us = table.time_us(forms["pair (shipped)"])
        for name, fn in forms.items():
            us = base_us if name.startswith("pair") else table.time_us(fn)
            table.row(f"{label} {name}", us, base_us, X.max_diff(outs[name], plain))
        checks[label] = {name: X.max_diff(outs[name], outs["pair (shipped)"]) for name in ("dual", "cat_e2e")}
        print(f"{label} max|d| against pair: dual {checks[label]['dual']:.3e}, "
              f"cat {checks[label]['cat_e2e']:.3e}", flush=True)
    launches = X.print_launches((dual_pair_cuda, cat_call_cuda))
    return {"rows": table.rows, "checks": checks, "launches": launches}


if __name__ == "__main__":
    main()
