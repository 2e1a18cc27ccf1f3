"""Per-call times of the attention kernels on one CUDA card, for A/B runs
of kernel variants.

    python3 rgqa_tpu_torch/tools/time_attention.py [--iters 50]
        [--only long short_fwd short_bwd headfold epilogue uniter]

Six groups, all by default (``--only`` picks some):

- ``long``: #1 (``fused_attention_cuda``) at LXMERT's 20x20 and 36x36,
  batch 256; #2 (``fused_attention_long_cuda``) at ViLT's 165x165,
  185x185 and 277x277, batch 256, and 597x597, batch 64 (``LONG_CASES``),
  beside its bound (``chip_smoke._bound_ms``) and one
  ``scaled_dot_product_attention`` call, each with its device time; #3L
  (``fused_attention_long_bwd_cuda``) at 165x165 and 185x185, batch 256;
  bf16, q, k, v as column views of one fused QKV product, the last
  quarter of the keys masked and one fully masked row;
- ``short_fwd``: #1 and #4 (``fused_attention_dropout_cuda``, rate 0.1)
  at LXMERT's four attention shapes (20x20, 36x36, 20x36, 36x20), batch
  256 and 64 (a training step's 32 + RP rows), bf16, each beside the one
  PyTorch call that computes its function (``scaled_dot_product_attention``,
  with ``dropout_p`` for #4), timed alike, its device time summed over
  every device event of the call;
- ``short_bwd``: #3 (``fused_attention_bwd_cuda``) and #5
  (``fused_attention_dropout_bwd_cuda``, rate 0.1) at the same shapes and
  batches, bf16;
- ``headfold``: 6d (``experiments.headfold_exp.headfold_cuda``) at every
  (variant, F) of the experiment, beside #1 (F = 1) and one
  ``scaled_dot_product_attention`` call, at the experiment's five shapes
  (56x56, 36x36, 20x36, 36x20, 20x20), batch 384 and 64, bf16, q, k, v
  contiguous, up to a quarter of each row's keys masked and one fully
  masked row, as the smoke's phase 13;
- ``epilogue``: 6c (``experiments.epilogue_exp.epi_fused_cuda``), the
  shipped ``split`` (#1, ``addmm``, the residual add, the port's
  LayerNorm) and the library composition (SDPA, ``addmm``, the residual
  add, ``layer_norm``) at LXMERT's four shapes, batch 384 and 64, bf16,
  the inputs of the smoke's phase 13, each beside the bound
  (``chip_smoke._bound``); device time summed over every device event of
  the call;
- ``uniter``: #1, #4, #3 and #5 at UNITER's 56x56 stream (20 text tokens
  + 36 RoI features), batch 256 (inference) and 64 (a training step's 32
  + RP rows), bf16, q, k, v as column views of one fused QKV product, the
  keys masked as UNITER's are (the pads of questions of 4-20 tokens
  between the words and the image keys, one fully masked row); each
  beside its bound (``chip_smoke._bound_ms``: bytes at 3.35 TB/s against
  the products at the bf16 tensor-core rate) and the one PyTorch call
  for its function (``scaled_dot_product_attention``; for #3 / #5 its
  forward and backward less its forward, as the smoke reckons it);

the short groups with q, k, v as the model hands them (column views of
the fused QKV or KV product), a quarter of the keys masked and one fully
masked row.  Each line gives ``chip_smoke.cuda_ms`` over ``--iters``
launches and the largest difference from the plain version; the
``long`` and short groups' lines also their device time per call, the
summed durations of
the call's kernels under ``torch.profiler`` (at batch 64 the host's cost
of a call, ~60-100 us, exceeds the kernels', and back-to-back CUDA-event
times measure the host).  The script imports and builds the checkout it
lies in, so a copy with an edited ``csrc/`` is timed by running that
copy's script by path; two variants alternate within one run on one
card: ``A B B A``.  It takes #3L's wrapper with or without the forward's
row statistics (``lse``), so it runs unchanged in a checkout from before
they existed.
"""

from __future__ import annotations

import argparse
import inspect
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from chip_smoke import cuda_ms  # noqa: E402  (the checkout this script lies in)


GROUPS = ("long", "short_fwd", "short_bwd", "headfold", "epilogue", "uniter")
E, HEADS = 768, 12


def device_us(fn, iters: int, match: str | None = "fused_attention") -> float | None:
    """Device time per call of ``fn``: the durations of the device events
    it causes whose name holds ``match`` (all of them when None), summed
    over ``iters`` calls under torch.profiler, after a warm-up step of as
    many calls that the profiler traces and discards (the first events of
    a profile are now and then lost).  A profile whose matching events are
    not a whole multiple of the calls lost some and is taken again; None
    when three in a row did."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        rows = [e for e in prof.key_averages()
                if e.device_time_total > 0 and (match is None or match in e.key)]
        events = sum(e.count for e in rows)
        if events and events % iters == 0:
            return sum(e.device_time_total for e in rows) / iters
    return None


def _device(us: float | None) -> str:
    return "not measured (the profiler lost events)" if us is None else f"{us:.1f} us"


def _sdpa(q, k, v, bias, rate: float):
    """The one PyTorch call for #1 (#4 with ``rate``): scaled_dot_product_attention
    on (B, H, S, D) views of the same inputs, the mask in their dtype."""
    import torch.nn.functional as F

    def heads(t):
        return t.view(t.shape[0], t.shape[1], HEADS, E // HEADS).transpose(1, 2)

    mask = bias.to(q.dtype)[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=mask,
                                                   dropout_p=rate)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=GROUPS)
    args = ap.parse_args(argv)
    import torch

    from rgqa_tpu_torch.ops import attention as att
    from rgqa_tpu_torch.ops._build import build_all

    if not torch.cuda.is_available():
        raise SystemExit("time_attention: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sources = {"long": ("fused_attention", "fused_attention_long", "fused_attention_long_bwd"),
               "short_fwd": ("fused_attention", "fused_attention_dropout"),
               "short_bwd": ("fused_attention_bwd", "fused_attention_dropout"),
               "headfold": ("fused_attention", "headfold"),
               "epilogue": ("fused_attention", "epilogue"),
               "uniter": ("fused_attention", "fused_attention_bwd", "fused_attention_dropout")}
    built = build_all(tuple(dict.fromkeys(n for grp in args.only for n in sources[grp])))
    print(f"{att.__file__}; {smi}; build s " + ", ".join(f"{n} {r.seconds:.2f}" for n, r in built.items()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "long" in args.only:
        _long(att, gen, args.iters)
    rate, seed = 0.1, 2**40 + 3
    short = {
        "short_fwd": (
            (att.fused_attention_cuda, att.attention_natural_ref, ()),
            (att.fused_attention_dropout_cuda, att.attention_dropout_ref, (rate, seed)),
        ),
        "short_bwd": (
            (att.fused_attention_bwd_cuda, att.attention_bwd_ref, ()),
            (att.fused_attention_dropout_bwd_cuda, att.attention_dropout_bwd_ref, (rate, seed)),
        ),
    }
    for group in ("short_fwd", "short_bwd"):
        if group in args.only:
            _short(short[group], group == "short_bwd", gen, args.iters)
    if "headfold" in args.only:
        _headfold(att, gen, args.iters)
    if "epilogue" in args.only:
        _epilogue(gen, args.iters)
    if "uniter" in args.only:
        _uniter(att, gen, args.iters, rate, seed)


# #2's timed shapes: ViLT-B/32 at 384 px (165 training, 185 serving) and
# 512 px (277), batch 256; 16 px patches (597), batch 64.
LONG_CASES = ((165, 256), (185, 256), (277, 256), (597, 64))


def _long_inputs(gen, s: int, b: int):
    """bf16 q, k, v as column views of one fused QKV product, the last
    quarter of the keys masked and one fully masked row."""
    import torch

    q, k, v = torch.randn(b, s, 3 * E, generator=gen, device="cuda").bfloat16().split(E, -1)
    bias = torch.zeros(b, s, device="cuda")
    bias[:, -(s // 4):] = -10000.0
    bias[b // 2] = -10000.0
    return q, k, v, bias


def _long(att, gen, iters: int) -> None:
    import torch

    from chip_smoke import _bound_ms

    b = 256
    for s in (20, 36):
        q, k, v, bias = _long_inputs(gen, s, b)
        call = lambda: att.fused_attention_cuda(q, k, v, bias, HEADS)  # noqa: E731
        err = (call().float() - att.attention_natural_ref(q, k, v, bias, HEADS).float()).abs().max().item()
        print(f"bfloat16 B={b} {s}x{s} fused_attention_cuda: {cuda_ms(call, iters=iters) * 1e3:.1f} us "
              f"per call, device {_device(device_us(call, iters))}, max|kernel-plain| {err:.3e}", flush=True)
    for s, b in LONG_CASES:
        q, k, v, bias = _long_inputs(gen, s, b)
        call = lambda: att.fused_attention_long_cuda(q, k, v, bias, HEADS)  # noqa: E731
        err = (call().float() - att.attention_natural_ref(q, k, v, bias, HEADS).float()).abs().max().item()
        bound, by = _bound_ms("fused_attention_long", b, s, s, 2)
        lib = _sdpa(q, k, v, bias, 0.0)
        print(f"bfloat16 B={b} {s}x{s} fused_attention_long_cuda: {cuda_ms(call, iters=iters) * 1e3:.1f} us "
              f"per call, device {_device(device_us(call, iters))}, bound {bound * 1e3:.1f} us ({by}), "
              f"max|kernel-plain| {err:.3e}; sdpa {cuda_ms(lib, iters=iters) * 1e3:.1f} us, "
              f"device {_device(device_us(lib, iters, match=None))}", flush=True)
        del q, k, v, bias
        torch.cuda.empty_cache()

    bwd = att.fused_attention_long_bwd_cuda
    takes_lse = "lse" in inspect.signature(bwd).parameters
    b = 256
    for s in (165, 185):
        q, k, v, bias = _long_inputs(gen, s, b)
        g = torch.randn(b, s, E, generator=gen, device="cuda").bfloat16()
        extra = (att.fused_attention_long_cuda(q, k, v, bias, HEADS, lse=True)[1],) if takes_lse else ()
        got = bwd(q, k, v, bias, g, HEADS, *extra)
        want = att.attention_bwd_ref(q, k, v, bias, g, HEADS)
        err = max((a.float() - w.float()).abs().max().item() for a, w in zip(got[:3], want[:3]))
        us = cuda_ms(lambda: bwd(q, k, v, bias, g, HEADS, *extra), iters=iters) * 1e3
        print(f"bfloat16 B={b} {s}x{s} {bwd.__name__}: {us:.1f} us per call, "
              f"max|kernel-plain| of dq, dk, dv {err:.3e}", flush=True)


def _short(pairs, backward: bool, gen, iters: int) -> None:
    """(kernel, plain, extra args) pairs at LXMERT's four shapes, batch 256
    and 64, bf16; the backward pairs take an output gradient."""
    import torch

    for batch in (256, 64):
        for sq, skv in ((20, 20), (36, 36), (20, 36), (36, 20)):
            if sq == skv:
                q, k, v = torch.randn(batch, sq, 3 * E, generator=gen, device="cuda").bfloat16().split(E, -1)
            else:
                q = torch.randn(batch, sq, E, generator=gen, device="cuda").bfloat16()
                k, v = torch.randn(batch, skv, 2 * E, generator=gen, device="cuda").bfloat16().split(E, -1)
            g = torch.randn(batch, sq, E, generator=gen, device="cuda").bfloat16()
            bias = torch.zeros(batch, skv, device="cuda")
            bias[:, -(skv // 4):] = -10000.0
            bias[batch // 2] = -10000.0
            args = (q, k, v, bias, g, HEADS) if backward else (q, k, v, bias, HEADS)
            for kernel, plain, extra in pairs:
                got = kernel(*args, *extra)
                want = plain(*args, *extra)
                pairs_out = zip(got, want) if backward else [(got, want)]
                err = max((a.float() - w.float()).abs().max().item() for a, w in pairs_out)
                call = lambda: kernel(*args, *extra)  # noqa: E731
                us = cuda_ms(call, iters=iters) * 1e3
                what = "dq, dk, dv, dbias" if backward else "out"
                print(f"bfloat16 B={batch} {sq}x{skv} {kernel.__name__}: {us:.1f} us per call, "
                      f"device {_device(device_us(call, iters))}, "
                      f"max|kernel-plain| of {what} {err:.3e}", flush=True)
                if not backward:  # the library yardstick: every device event of the call
                    lib = _sdpa(q, k, v, bias, extra[0] if extra else 0.0)
                    print(f"bfloat16 B={batch} {sq}x{skv} sdpa{' dropout' if extra else ''}: "
                          f"{cuda_ms(lib, iters=iters) * 1e3:.1f} us per call, "
                          f"device {_device(device_us(lib, iters, match=None))}", flush=True)


def _headfold(att, gen, iters: int) -> None:
    """6d at every (variant, F), #1 and SDPA, at the experiment's shapes."""
    import torch

    from rgqa_tpu_torch.experiments import headfold_exp as hf

    for batch in (384, 64):
        for sq, skv in hf.SHAPES:
            s = max(sq, skv)
            q, k, v = (torch.randn(batch, s, E, generator=gen, device="cuda").bfloat16()[:, :n].contiguous()
                       for n in (sq, skv, skv))
            pad = torch.randint(0, skv // 4 + 1, (batch, 1), generator=gen, device="cuda")
            bias = (torch.arange(skv, device="cuda")[None, :] >= skv - pad).float() * -10000.0
            bias[batch // 2] = -10000.0
            calls = [("fused_attention_cuda (F = 1)", lambda: att.fused_attention_cuda(q, k, v, bias, HEADS),
                      lambda: att.attention_natural_ref(q, k, v, bias, HEADS), "fused_attention")]
            for variant, fold in hf.CANDIDATES:
                calls.append((f"headfold_cuda {variant} F = {fold}",
                              lambda a=(q, k, v, bias, fold, variant): hf.headfold_cuda(*a),
                              lambda a=(q, k, v, bias, fold, variant): hf.headfold_ref(*a), "headfold"))
            for label, call, plain, match in calls:
                err = (call().float() - plain().float()).abs().max().item()
                print(f"bfloat16 B={batch} {sq}x{skv} {label}: {cuda_ms(call, iters=iters) * 1e3:.1f} us per call, "
                      f"device {_device(device_us(call, iters, match))}, max|kernel-plain| {err:.3e}", flush=True)
            lib = _sdpa(q, k, v, bias, 0.0)
            print(f"bfloat16 B={batch} {sq}x{skv} sdpa: {cuda_ms(lib, iters=iters) * 1e3:.1f} us per call, "
                  f"device {_device(device_us(lib, iters, match=None))}", flush=True)
            del q, k, v, bias
            torch.cuda.empty_cache()


def _epilogue(gen, iters: int) -> None:
    """6c, ``split`` and the library composition at LXMERT's four shapes."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import _bound, _exp_stream
    from rgqa_tpu_torch.experiments import epilogue_exp as ep

    for batch in (384, 64):
        for sq, skv in ep.SHAPES:
            q, k, v, m = _exp_stream(batch, max(sq, skv), torch.bfloat16, gen)
            q, k, v, m = (t[:, :n].contiguous() for t, n in ((q, sq), (k, skv), (v, skv), (m, skv)))
            res = torch.randn(batch, sq, E, generator=gen, device="cuda").bfloat16()
            w = (torch.randn(E, E, generator=gen, device="cuda") * 0.02).bfloat16()
            wb, be = (torch.randn(E, generator=gen, device="cuda") * 0.02 for _ in range(2))
            g = 1.0 + torch.randn(E, generator=gen, device="cuda") * 0.02
            args = (q, k, v, m, res, w, wb, g, be)
            ln = ep.layer_norm(g, be)
            sdpa = _sdpa(q, k, v, m, 0.0)

            def library():
                ctx = sdpa().transpose(1, 2).reshape(-1, E)
                y = torch.addmm(wb.to(q.dtype), ctx, w).view(q.shape) + res
                return F.layer_norm(y.float(), (E,), g, be, ep.EPS).to(q.dtype)

            want = ep.epi_fused_ref(*args)
            it = 2
            nbytes = batch * (2 * sq + 2 * skv) * E * it + batch * skv * 4 + batch * sq * E * it + E * E * it + 3 * E * 4
            flops = 4 * batch * HEADS * sq * skv * (E // HEADS) + 2 * batch * sq * E * E
            bound, by = _bound(nbytes, flops)
            for label, call, match in (("epi_fused_cuda", lambda: ep.epi_fused_cuda(*args), "epilogue"),
                                       ("split", lambda: ep.split(*args[:7], ln), None),
                                       ("library", library, None)):
                with torch.inference_mode():
                    err = (call().float() - want.float()).abs().max().item()
                    us = cuda_ms(call, iters=iters) * 1e3
                    dev = device_us(call, iters, match)
                print(f"bfloat16 B={batch} {sq}x{skv} {label}: {us:.1f} us per call, device {_device(dev)}, "
                      f"bound {bound * 1e3:.1f} us ({by}), max|this-plain| {err:.3e}", flush=True)
            del q, k, v, m, res, args
            torch.cuda.empty_cache()



def _uniter_inputs(gen, b: int):
    """bf16 q, k, v (column views of one fused QKV product), an output
    gradient and UNITER's (B, 56) mask (``chip_smoke._uniter_bias``)."""
    import torch

    from chip_smoke import UNITER, _uniter_bias

    s = UNITER[0]
    q, k, v = torch.randn(b, s, 3 * E, generator=gen, device="cuda").bfloat16().split(E, -1)
    g = torch.randn(b, s, E, generator=gen, device="cuda").bfloat16()
    return q, k, v, g, _uniter_bias(b, gen)


def _uniter(att, gen, iters: int, rate: float, seed: int) -> None:
    """#1 / #4 / #3 / #5 at 56x56, batch 256 and 64, beside bound and SDPA."""
    import torch

    from chip_smoke import _bound_ms, _sdpa_calls

    for b in (256, 64):
        q, k, v, g, bias = _uniter_inputs(gen, b)
        lib = _sdpa_calls(q, k, v, g, bias)
        cases = (
            (att.fused_attention_cuda, att.attention_natural_ref, (q, k, v, bias, HEADS), "fwd", None),
            (att.fused_attention_dropout_cuda, att.attention_dropout_ref,
             (q, k, v, bias, HEADS, rate, seed), "drop", None),
            (att.fused_attention_bwd_cuda, att.attention_bwd_ref, (q, k, v, bias, g, HEADS),
             "fwd_bwd", "fwd"),
            (att.fused_attention_dropout_bwd_cuda, att.attention_dropout_bwd_ref,
             (q, k, v, bias, g, HEADS, rate, seed), "drop_fwd_bwd", "drop"),
        )
        for kernel, plain, args, lib_all, lib_less in cases:
            got, want = kernel(*args), plain(*args)
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            err = max((a.float() - w.float()).abs().max().item() for a, w in pairs)
            call = lambda: kernel(*args)  # noqa: E731
            name = kernel.__name__.removesuffix("_cuda")
            bound, by = _bound_ms(name, b, 56, 56, 2)
            lib_us = cuda_ms(lib[lib_all], iters=iters) * 1e3
            lib_dev = device_us(lib[lib_all], iters, match=None)
            if lib_less:
                lib_us -= cuda_ms(lib[lib_less], iters=iters) * 1e3
                less = device_us(lib[lib_less], iters, match=None)
                lib_dev = None if lib_dev is None or less is None else lib_dev - less
            print(f"bfloat16 B={b} 56x56 uniter-mask {kernel.__name__}: {cuda_ms(call, iters=iters) * 1e3:.1f} "
                  f"us per call, device {_device(device_us(call, iters))}, bound {bound * 1e3:.1f} us ({by}), "
                  f"max|kernel-plain| {err:.3e}; sdpa {lib_us:.1f} us, device {_device(lib_dev)}", flush=True)
        del q, k, v, g, bias, lib
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
