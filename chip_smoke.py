#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rgqa_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or a few each; any failure raises, so the exit code is
nonzero:

1. device: the card's name and ``nvidia-smi``'s name and power limit;
   TF32 is turned off for matmuls and convolutions.  No CUDA -> exit 1.
2. build: compiles the five sources of ``rgqa_tpu_torch/csrc`` for sm_90a,
   one nvcc each, side by side (prints each build time and ptxas' report).
3. kernels: the six attention kernels against their plain PyTorch
   versions.  #2, the long-stream forward, at ViLT's shapes (165x165,
   185x185, and 65x185 / 185x65 for ragged query tiles), batch 256 and 7,
   f32 and bf16, with pad-patch style masks (padded text, trailing keys
   masked) and one fully masked row, bounds as #1's.  #3L, the
   long-stream backward, at the same shapes and at its limit of 256 keys
   (20x256, 256x256), with the same masks, bounds as #3's, and two runs
   equal bit for bit.  The other four at
   LXMERT's four attention shapes (20x20, 36x36, 20x36,
   36x20; 12 heads of 64), batch 256 and 7, with one fully masked row:
   #1 forward (bound 2e-5 in f32), #3 backward, #4 dropout forward and #5
   dropout backward at rate 0.1 (bounds 1e-4 in f32; dbias from bf16
   inputs 1e-3 + 1e-4 |plain|).  bf16 bound: 3e-2 + 1e-2 |plain| (the
   kernels round P and dS to bf16 where the plain versions keep f32; the
   relative term is one bf16 step of values above 4).  Rate 0 of #4 / #5
   equals #1 / #3 bit for bit; ``<g, out> == <dv, v>`` at rate 0.1 in f32
   (within 2e-3 relative; bf16 rounds P_drop and the output); the
   mask #4 applies, read out through a one-hot V, equals
   ``dropout_keep_mask_ref`` bit for bit, and its kept fraction at batch
   256 is within 5 sigma of (256 - t) / 256.  Per-call CUDA-event times of
   each kernel, its plain version and the one PyTorch call that computes
   the same function (``scaled_dot_product_attention``: forward; forward
   plus backward less forward; with ``dropout_p``), at batch 256 (#3L in
   bf16 only: its f32 body is checked, not timed).
4. model: full-width LxmertForGQA (9/5/5 layers x 768, vocab 30522, 1842
   answers, 36 x 2048 RoI features) in bf16 from a seeded generator at
   batch 256 with padded text (random lengths 4-20), once through the
   kernel and once through the plain version: 34 launches per forward,
   logits within 1e-1 of each other while the text mask alone moves them
   by more than 2e-1 (so the bound sees the bias), and forward
   questions/s.
5. evaluate path: ``python -m rgqa_tpu_torch.cli.evaluate --synthetic
   --test testdev --scorer msp`` at full width in a temporary directory,
   with the forward kernel's launch count reset before and read after:
   34 per forward times the number of batches, and no other kernel.
   Checks the prediction JSON and the AUAF / FF95 / FACC metric dict, and
   re-scores the split through the plain version.
6. vilt model: full-width ViltForGQA (ViLT-B/32: 12 layers x 768, vocab
   30522, 1842 answers, 384 px images in 32 px patches) in bf16 from a
   seeded generator at batch 256 with 40-token padded text (the 185-token
   stream) and the u8 pixel wire, three rows in four padded (rects of a
   2:1, 3:2 and 4:3 image in pad mode), once through the kernels and once
   through the plain version: 12 launches of #2 and none of #1 per
   forward, logits within 1e-1 while the pad-patch mask alone moves them
   by more than 2e-1, and forward questions/s.
7. vilt evaluate path: ``python -m rgqa_tpu_torch.cli.evaluate --backbone
   vilt --synthetic --test testdev --scorer msp`` at full width (165-token
   stream, pixels from the synthetic pixel pack), checked and re-scored as
   phase 5, through #2 alone, 12 launches per forward.
8. train steps: full-width LxmertForGQA with f32 master weights and bf16
   compute, ``--batchSize 32`` with RP pairing (64 rows), the same
   initial weights and the same 4 batches, run through the kernels and
   through the plain versions (``use_fused=False``), at dropout 0 (34
   launches of #1 and ``BWD_PER_STEP`` = 32 of #3 per step, none of #4 /
   #5; losses within ``LOSS_RTOL``) and at dropout 0.1 (34 of #4 and 32
   of #5 per step).
   Times ms per step and rows per second of each.
9. train path: ``python -m rgqa_tpu_torch.cli.train --synthetic
   --sample_pair --epochs 1 --batchSize 32`` at full width, dropout 0.1
   (the default): 8 steps, 34 x 8 launches of #4 and 32 x 8 of #5, finite
   losses, ``BEST.pth`` and ``LAST.pth`` written; then the evaluate CLI
   scores testdev from ``--load BEST.pth``.
10. vilt train steps: full-width ViltForGQA with f32 master weights and
   bf16 compute, the train CLI's 20-token text (a 165-token stream), the
   u8 wire with padded rects, ``--batchSize 32`` with RP pairing (64
   rows); the same initial weights and 4 batches through the kernels and
   through the plain versions: 12 launches of #2 and 12 of #3L per step
   and none of any other kernel (ViLT has no attention dropout), losses
   within ``LOSS_RTOL`` at dropout 0; ms per step and rows per second of
   each at dropout 0 and 0.1.
11. vilt train path: ``python -m rgqa_tpu_torch.cli.train --backbone vilt
   --synthetic --sample_pair --no_randaug --epochs 1 --batchSize 32`` at
   full width (the card machine has no PIL for randaug): 8 steps, 12 x 8
   launches of #3L, 12 per step and per validation forward of #2, none
   else; finite losses; ``BEST.pth`` and ``LAST.pth`` in the GQAViLT key
   format; then the evaluate CLI scores testdev from ``--load BEST.pth``.
12. the kernels' JSON line (times: the sum over the LXMERT shapes, and
   for #2 and #3L over 165x165 and 185x185, bf16, batch 256), the
   nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

Needs the repository beside it; it imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

E, HEADS = 768, 12
SHAPES = ((20, 20), (36, 36), (20, 36), (36, 20))  # (Sq, Skv) per LXMERT call kind
VILT_SHAPES = ((165, 165), (185, 185))  # ViLT's stream: 20 or 40 text tokens + 144 patches + CLS
LONG_SHAPES = VILT_SHAPES + ((65, 185), (185, 65))
LIMIT_SHAPES = ((20, 256), (256, 256))  # the long kernels' limit of 256 keys
# (atol, rtol) per kernel and dtype; see the docstring.
TOL = {
    ("fused_attention", "float32"): (2e-5, 0.0),
    ("fused_attention_long", "float32"): (2e-5, 0.0),
    ("float32",): (1e-4, 0.0),
    ("bfloat16",): (3e-2, 1e-2),
    ("dbias", "bfloat16"): (1e-3, 1e-4),
}
RATE = 0.1  # training's attention dropout
LOGIT_TOL = 1e-1  # bf16 model, kernel vs plain attention in all 34 calls
CONF_TOL = 3e-2  # MSP confidence, kernel vs plain, same bf16 weights
MIN_LABEL_AGREEMENT = 0.9
# Dropout-off training, kernels vs plain versions, relative per step.
# Both compute in bf16; the kernels round P and dS to bf16 where the plain
# versions keep f32, which moves the bf16 logits by up to ~5e-2 (phase 4);
# the BCE loss is the mean over 64 rows of a sum over 1842 answers (~1e3),
# and such per-logit errors of either sign move it by ~1e-4 relative.
LOSS_RTOL = 1e-3
# Attention backward launches per training step: 34 forward calls, but the
# last cross layer's vision stream (its vis <- lang cross call and its
# vision self call) feeds nothing the loss reads (the answer head pools the
# language stream), so autograd runs no backward for those two.
BWD_PER_STEP = 32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM: device memory
BF16_FLOP_PER_S = 989e12  # H100 SXM: dense bf16 tensor cores
KERNELS = {
    "fused_attention": ("rgqa_tpu_torch/csrc/fused_attention.cu", "rgqa_tpu/ops/attention.py:250"),
    "fused_attention_bwd": ("rgqa_tpu_torch/csrc/fused_attention_bwd.cu", "rgqa_tpu/ops/attention.py:448"),
    "fused_attention_dropout": ("rgqa_tpu_torch/csrc/fused_attention_dropout.cu", "rgqa_tpu/ops/attention.py:641"),
    "fused_attention_dropout_bwd": ("rgqa_tpu_torch/csrc/fused_attention_dropout.cu", "rgqa_tpu/ops/attention.py:691"),
    "fused_attention_long": ("rgqa_tpu_torch/csrc/fused_attention_long.cu", "rgqa_tpu/ops/attention.py:399"),
    # _fused_bwd_kernel at ViLT's streams (_fit_bwd_block's raised tiers).
    "fused_attention_long_bwd": ("rgqa_tpu_torch/csrc/fused_attention_long_bwd.cu", "rgqa_tpu/ops/attention.py:448"),
}
VILT_TRAIN_TEXT = 20  # the train CLI's --max_text_len: a 165-token stream


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(plain, kernel, **kw) -> tuple[float, float]:
    """Mean times of (plain, kernel) measured plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = cuda_ms(plain, **kw), cuda_ms(kernel, **kw), cuda_ms(kernel, **kw), cuda_ms(plain, **kw)
    return (p1 + p2) / 2, (k1 + k2) / 2


def counters():
    from rgqa_tpu_torch.ops import attention as att

    return {name: getattr(att, f"{name}_cuda") for name in KERNELS}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this smoke needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("device", f"{name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s); nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from rgqa_tpu_torch.ops._build import NVCC_FLAGS, SOURCES, build_all

    t0 = time.perf_counter()
    results = build_all(SOURCES)
    log("build", f"{len(results)} sources in {time.perf_counter() - t0:.3f} s, side by side "
        f"(nvcc {' '.join(NVCC_FLAGS)})")
    for name, res in results.items():
        how = f"built in {res.seconds:.3f} s" if res.seconds else "reused an existing build of this source"
        log("build", f"rgqa_tpu_torch/csrc/{name}.cu -> {res.path.name}: {how}")
        for line in res.log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "rror")):
                log("build", "  " + line.strip())


# ---------------------------------------------------------------------------
# Phase 3: kernels.
# ---------------------------------------------------------------------------


def _attention_inputs(b, sq, skv, dtype, gen):
    """q/k/v as the model makes them: column views of one fused QKV
    product (self-attention) or of a KV product (cross-attention), an
    output gradient, and a (B, Skv) -10000 mask with one fully masked row."""
    import torch

    dev = "cuda"
    if sq == skv:
        q, k, v = torch.randn(b, sq, 3 * E, generator=gen, device=dev).to(dtype).split(E, -1)
    else:
        q = torch.randn(b, sq, E, generator=gen, device=dev).to(dtype)
        k, v = torch.randn(b, skv, 2 * E, generator=gen, device=dev).to(dtype).split(E, -1)
    g = torch.randn(b, sq, E, generator=gen, device=dev).to(dtype)
    mask = (torch.rand(b, skv, generator=gen, device=dev) > 0.25).float()
    mask[:, 0] = 1.0
    mask[b // 2] = 0.0  # a fully masked row stays finite
    return q, k, v, g, (1.0 - mask) * -10000.0


def _bound_ms(name: str, b: int, sq: int, skv: int, itemsize: int) -> tuple[float, str]:
    """The least time the card needs for one call: each input read once,
    each output written once, over the memory rate, against the products'
    flops over the bf16 tensor-core rate."""
    d = E // HEADS
    act = b * (2 * sq + 2 * skv) * E * itemsize  # q, k, v, out (forward)
    mask = b * skv * 4
    if name.endswith("bwd"):
        nbytes = b * (3 * sq + 4 * skv) * E * itemsize + 2 * mask  # + g, dq, dk, dv; bias, dbias
        flops = 10 * b * HEADS * sq * skv * d  # S, dP, dV, dQ, dK
    else:
        nbytes = act + mask
        flops = 4 * b * HEADS * sq * skv * d  # S, PV
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def _sdpa_calls(q, k, v, g, bias):
    """The one PyTorch call for each kernel's function, on (B, H, S, D)
    views: forward, forward + backward, and both with dropout."""
    import torch
    import torch.nn.functional as F

    def heads(t):
        return t.view(t.shape[0], t.shape[1], HEADS, E // HEADS).transpose(1, 2)

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    mask = bias.to(q.dtype)[:, None, None, :]
    gh = heads(g)

    def fwd(p=0.0, grad=False):
        with torch.set_grad_enabled(grad):
            return F.scaled_dot_product_attention(*(heads(t) for t in leaves), attn_mask=mask, dropout_p=p)

    def fwd_bwd(p=0.0):
        return torch.autograd.grad(fwd(p, grad=True), leaves, gh)

    return {
        "fwd": lambda: fwd(),
        "fwd_bwd": lambda: fwd_bwd(),
        "drop": lambda: fwd(RATE),
        "drop_fwd_bwd": lambda: fwd_bwd(RATE),
    }


def _tol(name: str, part: str, dname: str) -> tuple[float, float]:
    if part == "dbias":
        return TOL[("dbias", "bfloat16")] if dname == "bfloat16" else TOL[("float32",)]
    return TOL.get((name, dname), TOL[(dname,)])


def _compare(name, dtype, got, want, errs) -> str:
    """Raise unless the kernel's outputs are within their bounds of the
    plain version's; record the worst output error; describe them."""
    import torch

    dname = str(dtype).split(".")[1]
    parts = ("dq", "dk", "dv", "dbias") if isinstance(got, tuple) else ("out",)
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    msgs = []
    for part, (a, w) in zip(parts, pairs):
        atol, rtol = _tol(name, part, dname)
        if not torch.isfinite(a.float()).all():
            raise AssertionError(f"{name} {part} not finite")
        diff = (a.float() - w.float()).abs()
        err = diff.max().item()
        if part != "dbias":
            errs[(name, dname)] = max(errs.get((name, dname), 0.0), err)
        msgs.append(f"{part} {err:.3e}")
        if not bool((diff <= atol + rtol * w.float().abs()).all()):
            raise AssertionError(
                f"{name} {dname} {part}: max|kernel-plain| {err:.3e} over {atol} + {rtol}|plain|")
    return f"{name} " + ", ".join(msgs)


def _mask_readout(att, gen):
    """#4's mask, read through q = k = 0 (uniform P) and a one-hot V:
    out[b, i, h*D + j] = keep(b, h, i, j) * scale / Skv."""
    import torch

    b, s, d = 256, 36, E // HEADS
    zeros = torch.zeros(b, s, E, device="cuda")
    v = torch.zeros(b, s, HEADS, d, device="cuda")
    v[:, torch.arange(s), :, torch.arange(s)] = 1.0
    v = v.reshape(b, s, E)
    bias = torch.zeros(b, s, device="cuda")
    seed = int(torch.randint(0, 2**62, (), generator=gen, device="cuda"))
    out = att.fused_attention_dropout_cuda(zeros, zeros, v, bias, HEADS, RATE, seed)
    got = out.reshape(b, s, HEADS, d)[..., :s].permute(0, 2, 1, 3) > 0
    want = att.dropout_keep_mask_ref(seed, b, HEADS, s, s, RATE, device="cuda")
    if not torch.equal(got, want):
        raise AssertionError(f"#4's mask differs from dropout_keep_mask_ref in {int((got != want).sum())} places")
    t = round(RATE * 256)
    keep_p = (256 - t) / 256
    frac = got.float().mean().item()
    sigma = math.sqrt(keep_p * (1 - keep_p) / got.numel())
    log("kernels", f"fused_attention_dropout mask (B=256, 36x36, seed {seed}) equals "
        f"dropout_keep_mask_ref bit for bit; kept fraction {frac:.6f} vs {keep_p:.6f} "
        f"({abs(frac - keep_p) / sigma:.2f} sigma, want < 5)")
    if abs(frac - keep_p) >= 5 * sigma:
        raise AssertionError("kept fraction outside 5 sigma")


def phase_kernels():
    import torch
    from rgqa_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(1234)
    errs, times = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for b in (256, 7):
            for sq, skv in SHAPES:
                q, k, v, g, bias = _attention_inputs(b, sq, skv, dtype, gen)
                seed = int(torch.randint(0, 2**62, (), generator=gen, device="cuda"))
                calls = {
                    "fused_attention": (
                        lambda: att.fused_attention_cuda(q, k, v, bias, HEADS),
                        lambda: att.attention_natural_ref(q, k, v, bias, HEADS)),
                    "fused_attention_bwd": (
                        lambda: att.fused_attention_bwd_cuda(q, k, v, bias, g, HEADS),
                        lambda: att.attention_bwd_ref(q, k, v, bias, g, HEADS)),
                    "fused_attention_dropout": (
                        lambda: att.fused_attention_dropout_cuda(q, k, v, bias, HEADS, RATE, seed),
                        lambda: att.attention_dropout_ref(q, k, v, bias, HEADS, RATE, seed)),
                    "fused_attention_dropout_bwd": (
                        lambda: att.fused_attention_dropout_bwd_cuda(q, k, v, bias, g, HEADS, RATE, seed),
                        lambda: att.attention_dropout_bwd_ref(q, k, v, bias, g, HEADS, RATE, seed)),
                }
                msgs = []
                for name, (kernel, plain) in calls.items():
                    got, want = kernel(), plain()
                    torch.cuda.synchronize()
                    msgs.append(_compare(name, dtype, got, want, errs))
                # Rate 0 is the deterministic pair, bit for bit.
                fwd0 = att.fused_attention_dropout_cuda(q, k, v, bias, HEADS, 0.0, seed)
                bwd0 = att.fused_attention_dropout_bwd_cuda(q, k, v, bias, g, HEADS, 0.0, seed)
                if not torch.equal(fwd0, calls["fused_attention"][0]()) or not all(
                    torch.equal(a, c) for a, c in zip(bwd0, calls["fused_attention_bwd"][0]())
                ):
                    raise AssertionError(f"rate 0 of #4/#5 differs from #1/#3 at {dname} B={b} {sq}x{skv}")
                msg = (f"{dname} B={b} {sq}x{skv}: max|kernel-plain| " + "; ".join(msgs)
                       + "; rate 0 == #1/#3")
                if dtype == torch.float32:
                    # The backward replays the forward's mask: <g, out> ==
                    # <dv, v> (in f32: bf16 rounds P_drop and out).
                    out = calls["fused_attention_dropout"][0]()
                    dv = calls["fused_attention_dropout_bwd"][0]()[2]
                    lhs = (out.double() * g.double()).sum().item()
                    rhs = (dv.double() * v.double()).sum().item()
                    if not abs(lhs - rhs) <= 2e-3 * abs(lhs):
                        raise AssertionError(f"<g, out> {lhs} != <dv, v> {rhs} at {dname} B={b} {sq}x{skv}")
                    msg += f"; <g,out>/<dv,v> - 1 = {lhs / rhs - 1:.1e}"
                if b == 256:
                    lib = _sdpa_calls(q, k, v, g, bias)
                    library = {
                        "fused_attention": cuda_ms(lib["fwd"]),
                        "fused_attention_bwd": cuda_ms(lib["fwd_bwd"]) - cuda_ms(lib["fwd"]),
                        "fused_attention_dropout": cuda_ms(lib["drop"]),
                        "fused_attention_dropout_bwd": cuda_ms(lib["drop_fwd_bwd"]) - cuda_ms(lib["drop"]),
                    }
                    for name, (kernel, plain) in calls.items():
                        plain_ms, kernel_ms = in_turns(plain, kernel)
                        bound, _ = _bound_ms(name, b, sq, skv, q.element_size())
                        times[(name, dname, sq, skv)] = (kernel_ms, plain_ms, library[name], bound)
                    msg += "; us kernel/plain/library/bound: " + ", ".join(
                        f"{n.replace('fused_attention', '#')} " + "/".join(
                            f"{x * 1e3:.1f}" for x in times[(n, dname, sq, skv)])
                        for n in calls
                    )
                log("kernels", msg)
    _mask_readout(att, gen)
    _long_kernel(att, gen, errs, times)
    return errs, times


def _pad_patch_bias(b, skv, gen):
    """A (B, Skv) -10000 mask shaped like ViLT's: text of random length
    in its first min(40, Skv / 3) keys, then image keys whose trailing
    pad patches (up to a quarter) are masked; row B/2 fully masked."""
    import torch

    t = min(40, skv // 3)
    keys = torch.arange(skv, device="cuda")[None, :]
    text_len = torch.randint(1, t + 1, (b, 1), generator=gen, device="cuda")
    pad = torch.randint(0, (skv - t) // 4 + 1, (b, 1), generator=gen, device="cuda")
    mask = (keys < text_len) | ((keys >= t) & (keys < skv - pad))
    mask[b // 2] = False
    return (~mask).float() * -10000.0


def _long_kernel(att, gen, errs, times):
    """#2 and #3L against their plain versions at ViLT's shapes and at the
    limit of 256 keys, #3L's two runs bit for bit; times at batch 256 and
    ViLT's shapes (#3L in bf16)."""
    import torch

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for b in (256, 7):
            for sq, skv in LONG_SHAPES + LIMIT_SHAPES:
                q, k, v, g, _ = _attention_inputs(b, sq, skv, dtype, gen)
                bias = _pad_patch_bias(b, skv, gen)
                calls = {
                    "fused_attention_long": (
                        lambda: att.fused_attention_long_cuda(q, k, v, bias, HEADS),
                        lambda: att.attention_natural_ref(q, k, v, bias, HEADS)),
                    "fused_attention_long_bwd": (
                        lambda: att.fused_attention_long_bwd_cuda(q, k, v, bias, g, HEADS),
                        lambda: att.attention_bwd_ref(q, k, v, bias, g, HEADS)),
                }
                msgs = []
                for name, (kernel, plain) in calls.items():
                    got, want = kernel(), plain()
                    torch.cuda.synchronize()
                    msgs.append(_compare(name, dtype, got, want, errs))
                if not all(torch.equal(a, c) for a, c in zip(got, calls["fused_attention_long_bwd"][0]())):
                    raise AssertionError(f"two runs of #3L differ at {dname} B={b} {sq}x{skv}")
                msg = (f"{dname} B={b} {sq}x{skv}: max|kernel-plain| " + "; ".join(msgs)
                       + "; #3L twice: equal bits")
                if b == 256 and (sq, skv) in LONG_SHAPES:
                    lib = _sdpa_calls(q, k, v, g, bias)
                    library = {"fused_attention_long": cuda_ms(lib["fwd"])}
                    timed = ["fused_attention_long"]
                    if dtype == torch.bfloat16:
                        library["fused_attention_long_bwd"] = (
                            cuda_ms(lib["fwd_bwd"]) - library["fused_attention_long"])
                        timed.append("fused_attention_long_bwd")
                    for name in timed:
                        plain_ms, kernel_ms = in_turns(calls[name][1], calls[name][0])
                        bound, _ = _bound_ms(name, b, sq, skv, q.element_size())
                        times[(name, dname, sq, skv)] = (kernel_ms, plain_ms, library[name], bound)
                    msg += "; us kernel/plain/library/bound: " + ", ".join(
                        f"{n.replace('fused_attention_long', '#2').replace('#2_bwd', '#3L')} "
                        + "/".join(f"{x * 1e3:.1f}" for x in times[(n, dname, sq, skv)])
                        for n in timed
                    )
                log("kernels", msg)
                del q, k, v, g, bias, got, want, calls
                torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 4-5: the forward and the evaluate path (slice 1).
# ---------------------------------------------------------------------------


def _padded_text(batch: dict, seed: int = 1) -> dict:
    """``batch`` with each row's text cut to a random length in [4, T]:
    pad ids 0 and mask 0 past it, as the synthetic split's encodings."""
    import numpy as np

    ids, mask = batch["input_ids"].copy(), batch["input_mask"].copy()
    b, t = ids.shape
    lengths = np.random.default_rng(seed).integers(4, t + 1, b)
    pad = np.arange(t)[None, :] >= lengths[:, None]
    ids[pad] = 0
    mask[pad] = 0
    return dict(batch, input_ids=ids, input_mask=mask)


def phase_model():
    import numpy as np
    import torch
    from rgqa_tpu_torch.data.batching import to_device
    from rgqa_tpu_torch.models.zoo import build_model, default_config, example_batch
    from rgqa_tpu_torch.ops import attention as att

    cfg = default_config()
    enc = cfg.encoder
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model, forward = build_model(cfg, use_bf16=True, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log("model", f"LxmertForGQA {enc.l_layers}/{enc.r_layers}/{enc.x_layers} layers x "
        f"{enc.hidden_size}, vocab {enc.vocab_size}, {cfg.num_answers} answers, "
        f"{n_params} params in bf16, built in {time.perf_counter() - t0:.2f} s")
    padded = _padded_text(example_batch(cfg, 256, seed=0))
    batch = to_device(padded, "cuda")
    with torch.inference_mode():
        before = att.fused_attention_cuda.launches
        out_k = forward(batch)
        torch.cuda.synchronize()
        launches = att.fused_attention_cuda.launches - before
        out_p = forward(batch, use_fused=False)
        torch.cuda.synchronize()
        if att.fused_attention_cuda.launches - before != launches:
            raise AssertionError("the plain forward launched the kernel")
        lk, lp = out_k["logits"].float(), out_p["logits"].float()
        if lk.shape != (256, cfg.num_answers) or not torch.isfinite(lk).all():
            raise AssertionError(f"logits {tuple(lk.shape)} not finite / wrong shape")
        err = (lk - lp).abs().max().item()
        # The same ids with the text mask all ones: how far the padding
        # bias moves the logits, i.e. what a kernel that dropped the bias
        # would be off by.
        unmasked = to_device(dict(padded, input_mask=np.ones_like(padded["input_mask"])), "cuda")
        effect = (forward(unmasked)["logits"].float() - lk).abs().max().item()
        log("model", f"text lengths {int(padded['input_mask'].sum(1).min())}-"
            f"{padded['input_mask'].shape[1]}; kernel launches per forward = "
            f"{launches} (want 34); max|logits kernel-plain| = {err:.3e} (bound "
            f"{LOGIT_TOL:.0e}, max|logit| {lp.abs().max().item():.3f}); the text "
            f"mask moves the logits by {effect:.3e} (want > {2 * LOGIT_TOL:.0e})")
        if launches != 34:
            raise AssertionError(f"{launches} kernel launches per forward, want 34")
        if not err <= LOGIT_TOL:
            raise AssertionError(f"logits disagree: {err}")
        if not effect > 2 * LOGIT_TOL:
            raise AssertionError(f"the text mask moves the logits by only {effect}: "
                                 "the kernel-vs-plain bound would not see the bias")
        plain_ms, kernel_ms = in_turns(
            lambda: forward(batch, use_fused=False), lambda: forward(batch),
            iters=10, warmup=2,
        )
    qps_k, qps_p = 256e3 / kernel_ms, 256e3 / plain_ms
    log("model", f"forward at batch 256 bf16: kernel {kernel_ms:.3f} ms ({qps_k:.1f} q/s), "
        f"plain attention {plain_ms:.3f} ms ({qps_p:.1f} q/s)")
    del model, forward, batch, unmasked, out_k, out_p
    torch.cuda.empty_cache()


def _check_eval_outputs(phase, out_dir, root, results, argv, seconds, launches):
    from rgqa_tpu_torch.data.dataset import GQADataset

    with open(os.path.join(out_dir, "testdev_predict.json")) as f:
        preds = json.load(f)
    ds = GQADataset(root, "testdev", add_uq=True)
    log(phase, f"evaluate CLI ({' '.join(argv)}) in {seconds:.2f} s: "
        f"{len(preds)} predictions for {len(ds)} questions, {launches} forward kernel launches")
    if launches <= 0:
        raise AssertionError("the evaluate path never launched the attention kernel")
    if sorted(p["questionId"] for p in preds) != sorted(d["question_id"] for d in ds.data):
        raise AssertionError("prediction JSON does not hold one row per question")
    if not all(0.0 <= p["confidence"] <= 1.0 and p["prediction"] in ds.label2ans for p in preds):
        raise AssertionError("prediction JSON holds an invalid confidence or answer")
    for key in ("auaf", "fpr@0.95acc", "full_acc"):
        if not isinstance(results.get(key), float) or math.isnan(results[key]):
            raise AssertionError(f"metric {key} missing or NaN: {results}")
    log(phase, "metrics: " + ", ".join(f"{k} {results[k]:.6f}" for k in ("auaf", "fpr@0.95acc", "full_acc")))
    return ds, preds


def phase_main_path(phase="main", extra=(), kernel="fused_attention", per_forward=34):
    """The evaluate CLI on a synthetic root (``extra`` flags added): its
    outputs, ``per_forward`` launches of ``kernel`` per batch and no other
    kernel, and a plain re-score."""
    import torch
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.runner import GQARunner
    from rgqa_tpu_torch.scorers.core import make_msp_scorer

    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_") as tmp:
        root, out_dir = os.path.join(tmp, "gqa"), os.path.join(tmp, "out")
        argv = [*extra, "--synthetic", "--data_root", root, "--test", "testdev",
                "--scorer", "msp", "--output", out_dir]
        reset_counts()
        t0 = time.perf_counter()
        results = evaluate.main(argv)["testdev"]
        seconds = time.perf_counter() - t0
        launches = read_counts()
        ds, preds = _check_eval_outputs(phase, out_dir, root, results, argv, seconds,
                                        launches[kernel])
        if any(n for name, n in launches.items() if name != kernel):
            raise AssertionError(f"the evaluate path launched another kernel than {kernel}: {launches}")
        cfg, device = evaluate.parse_args(argv[:-1] + [os.path.join(tmp, "plain")])
        forwards = math.ceil(len(ds) / cfg.train.batch_size)
        if launches[kernel] != per_forward * forwards:
            raise AssertionError(
                f"{launches[kernel]} launches of {kernel}, want {per_forward} per forward x "
                f"{forwards} forwards ({len(ds)} questions, batch {cfg.train.batch_size})")

        # Reference on the same split: the same runner and weights, with
        # every attention call through the plain version.
        runner = GQARunner(cfg, init_train=False, device=device)
        plain_forward = lambda batch: runner.forward(batch, use_fused=False)  # noqa: E731
        plain = runner.score_split(runner._encode(ds), scorer=make_msp_scorer(plain_forward))
        by_qid = {p["questionId"]: p for p in preds}
        agree = sum(by_qid[q]["prediction"] == a for q, (a, _) in plain.items()) / len(plain)
        dconf = max(abs(by_qid[q]["confidence"] - c) for q, (_, c) in plain.items())
        log(phase, f"vs plain attention: labels agree on {agree:.4f} of questions "
            f"(want >= {MIN_LABEL_AGREEMENT}), max|confidence diff| {dconf:.3e} (bound {CONF_TOL:.0e})")
        if read_counts() != launches:
            raise AssertionError("the plain re-scoring launched a kernel")
        if agree < MIN_LABEL_AGREEMENT or not dconf <= CONF_TOL:
            raise AssertionError(f"{phase}-path output disagrees with the plain version")
        del runner
        torch.cuda.empty_cache()
    return launches[kernel]


# ---------------------------------------------------------------------------
# Phases 6-7: ViLT (slice 3).
# ---------------------------------------------------------------------------


def phase_vilt_model():
    import torch
    from rgqa_tpu_torch.data.batching import to_device
    from rgqa_tpu_torch.models.zoo import build_model, default_config, example_batch

    cfg = default_config("vilt")
    enc = cfg.encoder
    t0 = time.perf_counter()
    model, forward = build_model(cfg, use_bf16=True, device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    stream = cfg.max_text_len + (cfg.vilt_image_size // cfg.vilt_patch_size) ** 2 + 1
    log("vilt", f"ViltForGQA {enc.num_layers} layers x {enc.hidden_size}, vocab {enc.vocab_size}, "
        f"{cfg.num_answers} answers, {cfg.vilt_image_size} px / {cfg.vilt_patch_size} px patches, "
        f"{stream}-token stream, {n_params} params in bf16, built in {time.perf_counter() - t0:.2f} s")
    # The u8 wire: text cut to random lengths, random uint8 pixels, and in
    # three rows of four the rect of a 2:1, 3:2 or 4:3 image in pad mode.
    host = _padded_text(example_batch(cfg, 256, seed=0, pixel_wire="u8"))
    batch = to_device(host, "cuda")
    with torch.inference_mode():
        reset_counts()
        out_k = forward(batch)
        torch.cuda.synchronize()
        launches = read_counts()
        out_p = forward(batch, use_fused=False)
        torch.cuda.synchronize()
        if read_counts() != launches:
            raise AssertionError("the plain forward launched a kernel")
        lk, lp = out_k["logits"].float(), out_p["logits"].float()
        if lk.shape != (256, cfg.num_answers) or not torch.isfinite(lk).all():
            raise AssertionError(f"logits {tuple(lk.shape)} not finite / wrong shape")
        err = (lk - lp).abs().max().item()
        # How far the pad-patch mask moves the logits: what a kernel that
        # dropped the bias would be off by.
        ones = torch.ones_like(batch["pixel_mask"])
        effect = (forward(batch, pixel_mask=ones)["logits"].float() - lk).abs().max().item()
        want = {name: 0 for name in KERNELS}
        want["fused_attention_long"] = enc.num_layers
        log("vilt", f"text lengths {int(host['input_mask'].sum(1).min())}-{cfg.max_text_len}, "
            f"pad patches per row up to {int((1 - host['pixel_mask']).sum(1).max())}; launches per "
            f"forward {launches} (want {enc.num_layers} of #2, none else); max|logits kernel-plain| "
            f"= {err:.3e} (bound {LOGIT_TOL:.0e}, max|logit| {lp.abs().max().item():.3f}); the "
            f"pad-patch mask moves the logits by {effect:.3e} (want > {2 * LOGIT_TOL:.0e})")
        if launches != want:
            raise AssertionError(f"launches per forward {launches}, want {want}")
        if not err <= LOGIT_TOL:
            raise AssertionError(f"logits disagree: {err}")
        if not effect > 2 * LOGIT_TOL:
            raise AssertionError(f"the pad-patch mask moves the logits by only {effect}: "
                                 "the kernel-vs-plain bound would not see the bias")
        plain_ms, kernel_ms = in_turns(
            lambda: forward(batch, use_fused=False), lambda: forward(batch), iters=10, warmup=2,
        )
    log("vilt", f"forward at batch 256 bf16: kernel {kernel_ms:.3f} ms ({256e3 / kernel_ms:.1f} q/s), "
        f"plain attention {plain_ms:.3f} ms ({256e3 / plain_ms:.1f} q/s)")
    del model, forward, batch, out_k, out_p
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 8-11: training (slices 2 and 4).
# ---------------------------------------------------------------------------


def _train_batches(cfg, n: int, b: int = 32):
    """``n`` full-width batches with padded text and one-hot targets (ViLT:
    the u8 wire with padded rects)."""
    import numpy as np
    from rgqa_tpu_torch.data.batching import to_device
    from rgqa_tpu_torch.models.zoo import example_batch

    out = []
    for i in range(n):
        batch = _padded_text(example_batch(cfg, b, seed=10 + i, pixel_wire="u8"), seed=20 + i)
        rng = np.random.default_rng(30 + i)
        target = np.zeros((b, cfg.num_answers), np.float32)
        target[np.arange(b), rng.integers(0, cfg.num_answers, b)] = 1.0
        batch.update(target=target, id_mask=np.ones(b, np.float32))
        out.append(to_device(batch, "cuda"))
    return out


def _train_model(dropout: float, backbone: str):
    import torch
    from rgqa_tpu_torch.models.zoo import build_model, default_config

    cfg = default_config(backbone)
    if backbone == "vilt":
        cfg = dataclasses.replace(cfg, max_text_len=VILT_TRAIN_TEXT)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, hidden_dropout=dropout, attention_dropout=dropout))
    model, forward = build_model(
        cfg, use_bf16=True, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0), train=True,
    )
    return cfg, model, forward


def _run_steps(model, forward, init, batches, use_fused, steps=None):
    """Steps from ``init`` with a fresh BertAdam; (losses, ms per step of
    the steps after the first ``len(batches)``)."""
    import torch
    from rgqa_tpu_torch.config import OptimConfig
    from rgqa_tpu_torch.ops.dropout import DropoutRng
    from rgqa_tpu_torch.train.optimizer import make_optimizer
    from rgqa_tpu_torch.train.step import make_train_step

    model.load_state_dict(init)
    steps = steps or len(batches)
    opt = make_optimizer(OptimConfig(), model.parameters(), t_total=steps)
    rng = DropoutRng(device=torch.Generator(device="cuda").manual_seed(1),
                     host=torch.Generator().manual_seed(1))
    step = make_train_step(forward, opt, sample_pair=True, rng=rng, use_fused=use_fused)
    losses = [step(batch)["loss"] for batch in batches]
    torch.cuda.synchronize()
    ms = None
    if steps > len(batches):
        t0 = time.perf_counter()
        for i in range(steps - len(batches)):
            step(batches[i % len(batches)])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (steps - len(batches))
    return [float(x) for x in losses], ms


def _step_launches(backbone: str, dropout: float) -> dict:
    """Kernel launches per training step: LXMERT's 34 forward and
    ``BWD_PER_STEP`` backward attention calls, through the dropout pair
    when dropout is on; ViLT's 12 and 12 through #2 and #3L (no attention
    dropout)."""
    want = {name: 0 for name in KERNELS}
    if backbone == "vilt":
        want.update({"fused_attention_long": 12, "fused_attention_long_bwd": 12})
    elif dropout == 0.0:
        want.update({"fused_attention": 34, "fused_attention_bwd": BWD_PER_STEP})
    else:
        want.update({"fused_attention_dropout": 34, "fused_attention_dropout_bwd": BWD_PER_STEP})
    return want


def phase_train_steps(backbone: str = "lxmert"):
    import torch

    phase = "train" if backbone == "lxmert" else f"{backbone}-train"
    n, timed = 4, 10
    rows = 64  # batch 32 plus its 32 RP pairs
    result = {}
    for dropout in (0.0, RATE):
        cfg, model, forward = _train_model(dropout, backbone)
        batches = _train_batches(cfg, n)
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        reset_counts()
        k_losses, _ = _run_steps(model, forward, init, batches, None)
        counts = read_counts()
        p_losses, _ = _run_steps(model, forward, init, batches, False)
        if read_counts() != counts:
            raise AssertionError("the plain steps launched a kernel")
        per_step = {name: c / n for name, c in counts.items()}
        want = _step_launches(backbone, dropout)
        rel = [abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses)]
        if not all(math.isfinite(x) for x in k_losses + p_losses):
            raise AssertionError(f"non-finite losses {k_losses} {p_losses}")
        # Time in turns: plain, kernels, kernels, plain.
        t = [_run_steps(model, forward, init, batches, fused, n + timed)[1]
             for fused in (False, None, None, False)]
        plain_ms, kernel_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        log(phase, f"dropout {dropout}: batch 32 + RP ({rows} rows), 4 steps from one init: "
            f"launches per step {per_step}; losses kernels {[round(x, 4) for x in k_losses]}, "
            f"plain {[round(x, 4) for x in p_losses]}, max relative gap {max(rel):.3e}"
            + (f" (bound {LOSS_RTOL:.0e})" if dropout == 0.0 else " (same masks: the same seeds and bytes)"))
        log(phase, f"dropout {dropout}: ms per step (mean of {timed} after 4 warm-up, in turns) "
            f"kernels {kernel_ms:.3f} ({rows * 1e3 / kernel_ms:.1f} rows/s), plain {plain_ms:.3f} "
            f"({rows * 1e3 / plain_ms:.1f} rows/s)")
        if per_step != want:
            raise AssertionError(f"launches per step {per_step}, want {want}")
        if dropout == 0.0 and not max(rel) <= LOSS_RTOL:
            raise AssertionError(f"dropout-off losses of the kernels and the plain versions differ by {max(rel)}")
        result[dropout] = (counts, kernel_ms, plain_ms)
        del model, forward, batches, init
        torch.cuda.empty_cache()
    return result


def phase_train_path():
    import torch
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.cli import train as train_cli

    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_train_") as tmp:
        root, out_dir = os.path.join(tmp, "gqa"), os.path.join(tmp, "snap")
        argv = ["--synthetic", "--data_root", root, "--sample_pair", "--epochs", "1",
                "--batchSize", "32", "--output", out_dir]
        reset_counts()
        t0 = time.perf_counter()
        history = train_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(out_dir, "log.log")) as f:
            epoch_line = f.read().strip().splitlines()[0]
        log("train", f"train CLI ({' '.join(argv)}) in {seconds:.2f} s: history {history}; "
            f"launches {launches}; log.log: {epoch_line!r}")
        steps = 256 // 32
        for name, per_step in (("fused_attention_dropout", 34),
                               ("fused_attention_dropout_bwd", BWD_PER_STEP)):
            if launches[name] != per_step * steps:
                raise AssertionError(f"{name}: {launches[name]} launches, want {per_step} x {steps}")
        if launches["fused_attention_bwd"]:
            raise AssertionError("the dropout-on train path launched the deterministic backward")
        if not all(math.isfinite(x) for x in history["loss"]):
            raise AssertionError(f"non-finite training loss {history['loss']}")
        for name in ("BEST.pth", "LAST.pth", "LAST.state.pt"):
            if not os.path.isfile(os.path.join(out_dir, name)):
                raise AssertionError(f"the train CLI wrote no {name}")

        eval_dir = os.path.join(tmp, "eval")
        eargv = ["--synthetic", "--data_root", root, "--test", "testdev", "--load",
                 os.path.join(out_dir, "BEST.pth"), "--output", eval_dir]
        reset_counts()
        t0 = time.perf_counter()
        results = evaluate.main(eargv)["testdev"]
        _check_eval_outputs("train", eval_dir, root, results, eargv, time.perf_counter() - t0,
                            read_counts()["fused_attention"])
        torch.cuda.empty_cache()
    return launches


def phase_vilt_train_path():
    """The ViLT train CLI at full width from the synthetic pixel pack, its
    launches, checkpoints and an evaluate of its ``BEST.pth``."""
    import torch
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.cli import train as train_cli
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.data.dataset import GQADataset

    phase = "vilt-train"
    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_vilt_train_") as tmp:
        root, out_dir = os.path.join(tmp, "gqa"), os.path.join(tmp, "snap")
        argv = ["--backbone", "vilt", "--synthetic", "--data_root", root, "--sample_pair",
                "--no_randaug", "--epochs", "1", "--batchSize", "32", "--output", out_dir]
        reset_counts()
        t0 = time.perf_counter()
        history = train_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(out_dir, "log.log")) as f:
            epoch_lines = f.read().strip().splitlines()
        log(phase, f"train CLI ({' '.join(argv)}) in {seconds:.2f} s: history {history}; "
            f"launches {launches}; log.log: {epoch_lines}")
        cfg, _ = parse_cli(argv)
        steps = len(GQADataset(root, cfg.data.train_splits)) // 32
        valid_forwards = math.ceil(len(GQADataset(root, cfg.data.valid_splits)) / 32)
        want = {name: 0 for name in KERNELS}
        want.update({"fused_attention_long": 12 * (steps + valid_forwards),
                     "fused_attention_long_bwd": 12 * steps})
        if launches != want:
            raise AssertionError(f"launches {launches}, want {want} ({steps} steps, "
                                 f"{valid_forwards} validation forwards)")
        if not all(math.isfinite(x) for x in history["loss"]):
            raise AssertionError(f"non-finite training loss {history['loss']}")
        for name in ("BEST.pth", "LAST.pth", "LAST.state.pt"):
            if not os.path.isfile(os.path.join(out_dir, name)):
                raise AssertionError(f"the ViLT train CLI wrote no {name}")
        for name in ("BEST.pth", "LAST.pth"):
            keys = torch.load(os.path.join(out_dir, name), map_location="cpu", weights_only=True)
            if "transformer.blocks.11.attn.qkv.weight" not in keys or any(
                    k.startswith("lxrt_encoder") for k in keys):
                raise AssertionError(f"{name} is not in the GQAViLT key format: {sorted(keys)[:4]}")
        log(phase, f"BEST.pth and LAST.pth in the GQAViLT key format ({len(keys)} tensors, "
            "fused attn.qkv)")

        eval_dir = os.path.join(tmp, "eval")
        eargv = ["--backbone", "vilt", "--synthetic", "--data_root", root, "--test", "testdev",
                 "--load", os.path.join(out_dir, "BEST.pth"), "--output", eval_dir]
        reset_counts()
        t0 = time.perf_counter()
        results = evaluate.main(eargv)["testdev"]
        counts = read_counts()
        _check_eval_outputs(phase, eval_dir, root, results, eargv, time.perf_counter() - t0,
                            counts["fused_attention_long"])
        if any(n for name, n in counts.items() if name != "fused_attention_long"):
            raise AssertionError(f"the ViLT evaluate path launched another kernel than #2: {counts}")
        torch.cuda.empty_cache()
    return launches


def main() -> None:
    kind, smi = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    phase_build()
    errs, times = phase_kernels()
    phase_model()
    eval_launches = phase_main_path()
    phase_vilt_model()
    vilt_launches = phase_main_path("vilt", ("--backbone", "vilt"), "fused_attention_long", 12)
    steps = phase_train_steps()
    train_launches = phase_train_path()
    phase_train_steps("vilt")
    vilt_train_launches = phase_vilt_train_path()

    launches = {
        "fused_attention": eval_launches,  # the evaluate path
        "fused_attention_bwd": steps[0.0][0]["fused_attention_bwd"],  # dropout-off steps
        "fused_attention_dropout": train_launches["fused_attention_dropout"],  # the train CLI
        "fused_attention_dropout_bwd": train_launches["fused_attention_dropout_bwd"],
        "fused_attention_long": vilt_launches,  # the ViLT evaluate path
        "fused_attention_long_bwd": vilt_train_launches["fused_attention_long_bwd"],  # the ViLT train CLI
    }
    rows = []
    for name, (source, replaces) in KERNELS.items():
        # One bf16 call at each main-path shape, batch 256 (CUDA events).
        shapes = VILT_SHAPES if name.startswith("fused_attention_long") else SHAPES
        per_shape = [times[(name, "bfloat16", sq, skv)] for sq, skv in shapes]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            # Worst bf16 disagreement over the shapes x batch 256 and 7.
            "max_abs_err": errs[(name, "bfloat16")],
            "ms": sum(t[0] for t in per_shape),
            "plain_ms": sum(t[1] for t in per_shape),
            "bound_ms": sum(t[3] for t in per_shape),
            "bound_by": _bound_ms(name, 256, *shapes[-1], 2)[1],
            "library_ms": sum(t[2] for t in per_shape),
        })
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
