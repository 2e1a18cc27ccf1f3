#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rgqa_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or a few each; any failure raises, so the exit code is
nonzero:

1. device: the card's name and ``nvidia-smi``'s name and power limit;
   TF32 is turned off for matmuls and convolutions.  No CUDA -> exit 1.
2. build: compiles ``rgqa_tpu_torch/csrc/fused_attention.cu`` for sm_90a
   (prints the build time and ptxas' resource report).
3. kernel: the fused-attention kernel against its plain PyTorch version
   at LXMERT's four attention shapes (20x20, 36x36, 20x36, 36x20; 12
   heads of 64), batch 256 and 7, with one fully masked row; bounds
   |kernel - plain| <= 2e-5 in f32 (summation order differs) and
   <= 3e-2 + 1e-2 |plain| in bf16 (the kernel rounds P to bf16, the plain
   version keeps it in f32; the relative term is one bf16 step of
   outputs above 4, which 3e-2 alone does not cover).  Times both with
   CUDA events.
4. model: full-width LxmertForGQA (9/5/5 layers x 768, vocab 30522, 1842
   answers, 36 x 2048 RoI features) in bf16 from a seeded generator at
   batch 256 with padded text (random lengths 4-20), once through the
   kernel and once through the plain version: 34 launches per forward,
   logits within 1e-1 of each other while the text mask alone moves them
   by more than 2e-1 (so the bound sees the bias), and forward
   questions/s.
5. main path: ``python -m rgqa_tpu_torch.cli.evaluate --synthetic --test
   testdev --scorer msp`` at full width in a temporary directory, with the
   kernel's launch count reset before and read after.  Checks the
   prediction JSON (one row per question) and the AUAF / FF95 / FACC
   metric dict, and re-scores the split through the plain version.
6. the kernels' JSON line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Needs the repository beside it; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

E, HEADS = 768, 12
SHAPES = ((20, 20), (36, 36), (20, 36), (36, 20))  # (Sq, Skv) per LXMERT call kind
TOL = {"float32": (2e-5, 0.0), "bfloat16": (3e-2, 1e-2)}  # (atol, rtol)
LOGIT_TOL = 1e-1  # bf16 model, kernel vs plain attention in all 34 calls
CONF_TOL = 3e-2  # MSP confidence, kernel vs plain, same bf16 weights
MIN_LABEL_AGREEMENT = 0.9


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
    from rgqa_tpu_torch.ops._build import NVCC_FLAGS, build

    res = build("fused_attention")
    how = f"built in {res.seconds:.3f} s" if res.seconds else "reused an existing build of this source"
    log("build", f"rgqa_tpu_torch/csrc/fused_attention.cu -> {res.path.name}: {how} "
        f"(nvcc {' '.join(NVCC_FLAGS)})")
    for line in res.log.splitlines():
        if line.strip():
            log("build", line.strip())
    return res


def _attention_inputs(b, sq, skv, dtype, gen):
    """q/k/v as the model makes them: column views of one fused QKV
    product (self-attention) or of a KV product (cross-attention), and a
    (B, Skv) -10000 mask with one fully masked row."""
    import torch

    dev = "cuda"
    if sq == skv:
        q, k, v = torch.randn(b, sq, 3 * E, generator=gen, device=dev).to(dtype).split(E, -1)
    else:
        q = torch.randn(b, sq, E, generator=gen, device=dev).to(dtype)
        k, v = torch.randn(b, skv, 2 * E, generator=gen, device=dev).to(dtype).split(E, -1)
    mask = (torch.rand(b, skv, generator=gen, device=dev) > 0.25).float()
    mask[:, 0] = 1.0
    mask[b // 2] = 0.0  # a fully masked row stays finite
    return q, k, v, (1.0 - mask) * -10000.0


def phase_kernel():
    import torch
    from rgqa_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst = {}
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for b in (256, 7):
            for sq, skv in SHAPES:
                q, k, v, bias = _attention_inputs(b, sq, skv, dtype, gen)
                out = att.fused_attention_cuda(q, k, v, bias, HEADS)
                ref = att.attention_natural_ref(q, k, v, bias, HEADS)
                torch.cuda.synchronize()
                if out.shape != ref.shape or out.dtype != dtype:
                    raise AssertionError(f"kernel output {out.shape} {out.dtype} vs {ref.shape}")
                if not torch.isfinite(out).all():
                    raise AssertionError(f"kernel output not finite at {dname} B={b} {sq}x{skv}")
                diff = (out.float() - ref.float()).abs()
                atol, rtol = TOL[dname]
                err = diff.max().item()
                ok = bool((diff <= atol + rtol * ref.float().abs()).all())
                worst[dname] = max(worst.get(dname, 0.0), err)
                msg = (f"{dname} B={b} {sq}x{skv}: max|kernel-plain| = {err:.3e} "
                       f"(bound {atol:.0e} + {rtol:.0e}|plain|: {'ok' if ok else 'EXCEEDED'})")
                if b == 256:
                    plain_ms, kernel_ms = in_turns(
                        lambda: att.attention_natural_ref(q, k, v, bias, HEADS),
                        lambda: att.fused_attention_cuda(q, k, v, bias, HEADS),
                    )
                    times[(dname, sq, skv)] = (kernel_ms, plain_ms)
                    msg += f"; kernel {kernel_ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us"
                log("kernel", msg)
                if not ok:
                    raise AssertionError(f"kernel disagrees with plain: {msg}")
    return worst, times


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
    return qps_k, qps_p


def phase_main_path():
    import torch
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.ops import attention as att
    from rgqa_tpu_torch.runner import GQARunner
    from rgqa_tpu_torch.scorers.core import make_msp_scorer

    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_") as tmp:
        root, out_dir = os.path.join(tmp, "gqa"), os.path.join(tmp, "out")
        argv = ["--synthetic", "--data_root", root, "--test", "testdev",
                "--scorer", "msp", "--output", out_dir]
        att.fused_attention_cuda.launches = 0
        t0 = time.perf_counter()
        results = evaluate.main(argv)["testdev"]
        seconds = time.perf_counter() - t0
        launches = att.fused_attention_cuda.launches

        with open(os.path.join(out_dir, "testdev_predict.json")) as f:
            preds = json.load(f)
        ds = GQADataset(root, "testdev", add_uq=True)
        log("main", f"evaluate CLI ({' '.join(argv)}) in {seconds:.2f} s: "
            f"{len(preds)} predictions for {len(ds)} questions, {launches} kernel launches")
        if launches <= 0:
            raise AssertionError("the main path never launched the attention kernel")
        if sorted(p["questionId"] for p in preds) != sorted(d["question_id"] for d in ds.data):
            raise AssertionError("prediction JSON does not hold one row per question")
        if not all(0.0 <= p["confidence"] <= 1.0 and p["prediction"] in ds.label2ans for p in preds):
            raise AssertionError("prediction JSON holds an invalid confidence or answer")
        for key in ("auaf", "fpr@0.95acc", "full_acc"):
            if not isinstance(results.get(key), float) or math.isnan(results[key]):
                raise AssertionError(f"metric {key} missing or NaN: {results}")
        log("main", "metrics: " + ", ".join(f"{k} {results[k]:.6f}" for k in ("auaf", "fpr@0.95acc", "full_acc")))

        # Reference on the same split: the same runner and weights, with
        # every attention call through the plain version.
        runner = GQARunner(evaluate.parse_args(argv[:-1] + [os.path.join(tmp, "plain")]))
        plain_forward = lambda batch: runner.forward(batch, use_fused=False)  # noqa: E731
        plain = runner.score_split(runner._encode(ds), scorer=make_msp_scorer(plain_forward))
        by_qid = {p["questionId"]: p for p in preds}
        agree = sum(by_qid[q]["prediction"] == a for q, (a, _) in plain.items()) / len(plain)
        dconf = max(abs(by_qid[q]["confidence"] - c) for q, (_, c) in plain.items())
        log("main", f"vs plain attention: labels agree on {agree:.4f} of questions "
            f"(want >= {MIN_LABEL_AGREEMENT}), max|confidence diff| {dconf:.3e} (bound {CONF_TOL:.0e})")
        if att.fused_attention_cuda.launches != launches:
            raise AssertionError("the plain re-scoring launched the kernel")
        if agree < MIN_LABEL_AGREEMENT or not dconf <= CONF_TOL:
            raise AssertionError("main-path output disagrees with the plain version")
        del runner
        torch.cuda.empty_cache()
    return launches


def main() -> None:
    kind, smi = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    phase_build()
    worst, times = phase_kernel()
    phase_model()
    launches = phase_main_path()

    bf16 = [times[("bfloat16", sq, skv)] for sq, skv in SHAPES]
    kernels = {"kernels": [{
        "name": "fused_attention",
        "route": "cuda",
        "source": "rgqa_tpu_torch/csrc/fused_attention.cu",
        "replaces": "rgqa_tpu/ops/attention.py:250",
        "launches": launches,
        # Worst bf16 disagreement over the 4 shapes x batch 256 and 7.
        "max_abs_err": worst["bfloat16"],
        # One call at each of the 4 shapes, batch 256, bf16 (CUDA events).
        "ms": sum(k for k, _ in bf16),
        "plain_ms": sum(p for _, p in bf16),
    }]}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
