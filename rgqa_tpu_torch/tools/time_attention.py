"""Per-call times of the attention kernels on one CUDA card, for A/B runs
of kernel variants.

    python3 rgqa_tpu_torch/tools/time_attention.py [--iters 50]

Times #1 (``fused_attention_cuda``) at LXMERT's 20x20 and 36x36 and #2
(``fused_attention_long_cuda``) at ViLT's 165x165 and 185x185, batch 256,
12 heads of 64, bf16 and f32, and #3L (``fused_attention_long_bwd_cuda``)
at 165x165 and 185x185, batch 256, bf16, with q, k, v as column views of
one fused QKV product and the last quarter of the keys masked; then #3
(``fused_attention_bwd_cuda``) and #5 (``fused_attention_dropout_bwd_cuda``,
rate 0.1) at LXMERT's four attention shapes (20x20, 36x36, 20x36, 36x20),
batch 256 and 64 (a training step's 32 + RP rows), bf16, with q, k, v as
the model hands them (column views of the fused QKV or KV product), a
quarter of the keys masked and one fully masked row:
``chip_smoke.cuda_ms`` over ``--iters`` launches.  Each line also gives
the largest difference from the plain version, and the lines of #3 and
#5 their device time per call, the summed durations of the call's
kernels under ``torch.profiler`` (at batch 64 the host's cost of a call,
~60-100 us, exceeds the kernels', and back-to-back CUDA-event times
measure the host).  The script imports and
builds the checkout it lies in, so a copy with an edited ``csrc/`` is
timed by running that copy's script by path; two variants alternate
within one run on one card: ``A B B A``.  It takes #3L's wrapper with or
without the forward's row statistics (``lse``), so it runs unchanged in
a checkout from before they existed.
"""

from __future__ import annotations

import argparse
import inspect
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def device_us(fn, iters: int) -> float:
    """Device time per call of ``fn``: the durations of the attention
    kernels it launches, summed over ``iters`` calls under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records no device event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages() if "fused_attention" in e.key)
        if total:
            return total / iters
    raise RuntimeError("torch.profiler recorded no attention kernel in three tries")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    import torch

    from chip_smoke import cuda_ms
    from rgqa_tpu_torch.ops import attention as att
    from rgqa_tpu_torch.ops._build import build_all

    if not torch.cuda.is_available():
        raise SystemExit("time_attention: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    built = build_all(("fused_attention", "fused_attention_long", "fused_attention_long_bwd",
                       "fused_attention_bwd", "fused_attention_dropout"))
    print(f"{att.__file__}; {smi}; build s " + ", ".join(f"{n} {r.seconds:.2f}" for n, r in built.items()))
    e, heads, b = 768, 12, 256
    gen = torch.Generator(device="cuda").manual_seed(0)

    cases = ((20, att.fused_attention_cuda), (36, att.fused_attention_cuda),
             (165, att.fused_attention_long_cuda), (185, att.fused_attention_long_cuda))
    for dtype in (torch.bfloat16, torch.float32):
        for s, kernel in cases:
            q, k, v = torch.randn(b, s, 3 * e, generator=gen, device="cuda").to(dtype).split(e, -1)
            bias = torch.zeros(b, s, device="cuda")
            bias[:, -(s // 4):] = -10000.0
            err = (kernel(q, k, v, bias, heads).float()
                   - att.attention_natural_ref(q, k, v, bias, heads).float()).abs().max().item()
            us = cuda_ms(lambda: kernel(q, k, v, bias, heads), iters=args.iters) * 1e3
            print(f"{str(dtype).split('.')[1]} B={b} {s}x{s} {kernel.__name__}: {us:.1f} us "
                  f"per call, max|kernel-plain| {err:.3e}", flush=True)

    bwd = att.fused_attention_long_bwd_cuda
    takes_lse = "lse" in inspect.signature(bwd).parameters
    for s in (165, 185):
        q, k, v = torch.randn(b, s, 3 * e, generator=gen, device="cuda").bfloat16().split(e, -1)
        g = torch.randn(b, s, e, generator=gen, device="cuda").bfloat16()
        bias = torch.zeros(b, s, device="cuda")
        bias[:, -(s // 4):] = -10000.0
        extra = (att.fused_attention_long_cuda(q, k, v, bias, heads, lse=True)[1],) if takes_lse else ()
        got = bwd(q, k, v, bias, g, heads, *extra)
        want = att.attention_bwd_ref(q, k, v, bias, g, heads)
        err = max((a.float() - w.float()).abs().max().item() for a, w in zip(got[:3], want[:3]))
        us = cuda_ms(lambda: bwd(q, k, v, bias, g, heads, *extra), iters=args.iters) * 1e3
        print(f"bfloat16 B={b} {s}x{s} {bwd.__name__}: {us:.1f} us per call, "
              f"max|kernel-plain| of dq, dk, dv {err:.3e}", flush=True)

    rate, seed = 0.1, 2**40 + 3
    short = (
        (att.fused_attention_bwd_cuda, att.attention_bwd_ref, ()),
        (att.fused_attention_dropout_bwd_cuda, att.attention_dropout_bwd_ref, (rate, seed)),
    )
    for batch in (256, 64):
        for sq, skv in ((20, 20), (36, 36), (20, 36), (36, 20)):
            if sq == skv:
                q, k, v = torch.randn(batch, sq, 3 * e, generator=gen, device="cuda").bfloat16().split(e, -1)
            else:
                q = torch.randn(batch, sq, e, generator=gen, device="cuda").bfloat16()
                k, v = torch.randn(batch, skv, 2 * e, generator=gen, device="cuda").bfloat16().split(e, -1)
            g = torch.randn(batch, sq, e, generator=gen, device="cuda").bfloat16()
            bias = torch.zeros(batch, skv, device="cuda")
            bias[:, -(skv // 4):] = -10000.0
            bias[batch // 2] = -10000.0
            for kernel, plain, extra in short:
                got = kernel(q, k, v, bias, g, heads, *extra)
                want = plain(q, k, v, bias, g, heads, *extra)
                err = max((a.float() - w.float()).abs().max().item() for a, w in zip(got, want))
                call = lambda: kernel(q, k, v, bias, g, heads, *extra)  # noqa: E731
                us = cuda_ms(call, iters=args.iters) * 1e3
                print(f"bfloat16 B={batch} {sq}x{skv} {kernel.__name__}: {us:.1f} us per call, "
                      f"device {device_us(call, args.iters):.1f} us, "
                      f"max|kernel-plain| of dq, dk, dv, dbias {err:.3e}", flush=True)


if __name__ == "__main__":
    main()
