"""Per-call times of the attention forward kernels on one CUDA card, for
A/B runs of kernel variants.

    python3 rgqa_tpu_torch/tools/time_attention.py [--iters 50]

Times #1 (``fused_attention_cuda``) at LXMERT's 20x20 and 36x36 and #2
(``fused_attention_long_cuda``) at ViLT's 165x165 and 185x185, batch 256,
12 heads of 64, bf16 and f32, with q, k, v as column views of one fused
QKV product and the last quarter of the keys masked: ``chip_smoke.cuda_ms``
over ``--iters`` launches.  Each line also gives the largest difference
from the plain version.  The script imports and builds the checkout it
lies in, so a copy with an edited ``csrc/`` is timed by running that
copy's script by path; two variants alternate within one run on one
card: ``A B B A``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


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
    built = build_all(("fused_attention", "fused_attention_long"))
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


if __name__ == "__main__":
    main()
