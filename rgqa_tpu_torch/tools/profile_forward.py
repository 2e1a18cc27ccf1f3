"""Where the time of the full-width LXMERT forward goes, on one CUDA card.

    python -m rgqa_tpu_torch.tools.profile_forward [--batch 256 32]
        [--iters 20] [--repeats 3] [--out chiprun_out/profile_forward.json]

Builds ``LxmertForGQA`` at full width (``zoo.default_config``) in bf16
from seed 0 and, for each batch size of ``zoo.example_batch``, runs the
forward through the attention kernel and through the plain version:

- wall per forward: the best of ``--repeats`` means over ``--iters``
  forwards, synchronised at both ends, for every run before the first
  profile;
- device time per forward by kernel class, from ``torch.profiler`` over
  ``--iters`` forwards (CUDA kernel, memcpy and memset events, summed;
  one stream, so they do not overlap), and the busy share, device time
  over wall.

Prints one table per run and writes every number to ``--out`` as JSON.
Raises if there is no card or the profiler records no device time.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import time
from collections import defaultdict

import torch

from rgqa_tpu_torch.data.batching import to_device
from rgqa_tpu_torch.models.zoo import build_model, default_config, example_batch
from rgqa_tpu_torch.ops import attention as att

# (class, substrings of the lower-cased kernel name), first match wins.
KERNEL_CLASSES = (
    ("attention kernel", ("fused_attention",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "wgmma")),
    ("layer norm", ("layer_norm",)),
    ("gelu", ("gelu",)),
    ("softmax", ("softmax",)),
    ("weight concat", ("catarray",)),
    ("copy / cast", ("copy",)),
    ("memcpy / memset", ("memcpy", "memset")),
)
OTHER = "other"


def classify(kernel_name: str) -> str:
    """The class of a device kernel, by its name."""
    name = kernel_name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return OTHER


def _wall_ms(fn, iters: int, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3 / iters)
    return best


def _device_time(fn, iters: int) -> dict:
    """Per forward: {class: (ms, launches)} from the profiler's device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us, count = defaultdict(float), defaultdict(int)
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            cls = classify(evt.name)
            us[cls] += evt.time_range.elapsed_us()
            count[cls] += 1
    if not us:
        raise RuntimeError("torch.profiler recorded no device time")
    return {cls: (us[cls] / 1e3 / iters, count[cls] / iters) for cls in us}


def _summary(size: int, route: str, per_forward: int, wall: float, classes: dict) -> dict:
    device_ms = sum(ms for ms, _ in classes.values())
    return {
        "batch": size, "route": route, "attention_launches": per_forward,
        "wall_ms": wall, "questions_per_s": size * 1e3 / wall,
        "device_ms": device_ms, "busy_share": device_ms / wall,
        "launches": sum(n for _, n in classes.values()),
        "classes": {
            cls: {"ms": ms, "share": ms / device_ms, "launches": n}
            for cls, (ms, n) in sorted(classes.items(), key=lambda kv: -kv[1][0])
        },
    }


def _print_run(run: dict) -> None:
    print(f"batch {run['batch']}, {run['route']}: wall {run['wall_ms']:.3f} ms per forward "
          f"({run['questions_per_s']:.1f} q/s), device {run['device_ms']:.3f} ms "
          f"({100 * run['busy_share']:.1f}% busy), {run['launches']:.0f} device launches, "
          f"{run['attention_launches']} through the attention kernel")
    for cls, c in run["classes"].items():
        print(f"    {cls:<18} {c['ms']:8.3f} ms  {100 * c['share']:5.1f}%  {c['launches']:6.0f} launches")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[256, 32])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "profile_forward.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch {torch.__version__}")

    cfg = default_config()
    _, forward = build_model(
        cfg, use_bf16=True, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0),
    )
    fns = {}
    for size in args.batch:
        batch = to_device(example_batch(cfg, size, seed=0), "cuda")
        fns[(size, "kernel")] = functools.partial(forward, batch)
        fns[(size, "plain")] = functools.partial(forward, batch, use_fused=False)
    walls = {}
    runs = []
    with torch.inference_mode():
        for case, fn in fns.items():
            for _ in range(3):  # warm-up: cuBLAS heuristics, allocator
                fn()
            before = att.fused_attention_cuda.launches
            fn()
            torch.cuda.synchronize()
            per_forward = att.fused_attention_cuda.launches - before
            walls[case] = (per_forward, _wall_ms(fn, args.iters, args.repeats))
        # Every wall is taken before the first profile: launches from the
        # host run slower once the profiler has been on.
        for case, fn in fns.items():
            runs.append(_summary(*case, *walls[case], _device_time(fn, args.iters)))
            _print_run(runs[-1])
        first = next(iter(fns))
        after = _wall_ms(fns[first], args.iters, args.repeats)
    print(f"batch {first[0]}, {first[1]}: wall {after:.3f} ms per forward after the "
          f"profiles, {walls[first][1]:.3f} ms before")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "torch": torch.__version__, "runs": runs,
                       "first_wall_after_profiles_ms": after}, f, indent=1)
    return runs


if __name__ == "__main__":
    main()
