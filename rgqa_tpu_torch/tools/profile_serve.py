"""The serving path's numbers on one CUDA card: the JSONL scoring service
(``cli/serve.py``) and the data preparation that feeds it.

    python -m rgqa_tpu_torch.tools.profile_serve [--records 4096]
        [--batch 256] [--latency_records 60] [--interval 0.1]
        [--latency_batches 256 8] [--tsv_rows 512] [--out FILE.json]

At full width (``zoo.default_config``: LXMERT 9 / 5 / 5 x 768, 1842
answers, 36 x 2048 RoIs; ViLT-B/32), bf16 weights from the runner's
seeded generator, on a synthetic root in a temporary directory:

1. decoder: a TSV of ``--tsv_rows`` rows (36 x 2048 f32 features, seeded)
   packed by ``pack_obj_tsv``, wall and MB/s of TSV, and its decoder
   alone (``load_obj_tsv``, no pack written);
2. throughput: a stream of ``--records`` records (the testdev questions
   over and over, each with its own id) through ``serve.main`` at
   ``--batch``, ``--scorer msp``, in one wave (``--wave_timeout 0``):
   questions/s over the stream's window (from the first record's arrival
   to the last answer written: reading, parsing, encoding, scoring and
   writing), and within it the host encode (``runner._encode``: tokenize,
   image lookup) and the scoring loop (``runner.score_rows``: batch
   gather, copy, forward, fetch); a second run profiles only the scoring
   loop (``torch.profiler`` around each ``score_rows`` call) for its
   device time and busy share (that device time over the first run's
   loop wall); and the loop's feed alone over the wave's encoded rows
   (the host gather of every batch; the gather with the pinned copy to
   the card); then the same with ``--backbone vilt`` (165 tokens: the
   CLI's 20 text tokens and 144 patches at 384 px);
3. latency: ``--latency_records`` records arriving one every
   ``--interval`` s through ``serve.main --serve_stats`` at each of
   ``--latency_batches``: the stats line's p50 / p95 / p99, and the
   waves' mean encode and scoring-loop walls.

Prints each number as it comes and, given ``--out``, writes them all as
JSON.  Runs on the card unless given ``--device cpu`` (then add ``--tiny``
for a 1-layer, 32-wide model; no device time is measured there).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import tempfile
import time

import torch

from rgqa_tpu_torch.cli import serve
from rgqa_tpu_torch.data import tsv
from rgqa_tpu_torch.data.batching import batch_iterator, device_prefetch
from rgqa_tpu_torch.data.synthetic import make_synthetic_gqa, random_obj_rows, serve_records
from rgqa_tpu_torch.eval import ScoringMixin
from rgqa_tpu_torch.runner import GQARunner

TINY = ["--fp32", "--llayers", "1", "--xlayers", "1", "--rlayers", "1", "--num_layers", "1",
        "--hidden_size", "32", "--num_heads", "4"]


def device_ms(fn) -> float:
    """Device time (ms) of the CUDA kernels, copies and sets that ``fn``
    launches, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    if not us:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / 1e3


@contextlib.contextmanager
def timed_waves(profiled: bool = False):
    """Record the wall of each wave's host encode (``GQARunner._encode``)
    and scoring loop (``ScoringMixin.score_rows``, synchronised) while
    open, and with ``profiled`` each scoring loop's device time under
    ``torch.profiler``: yields ``{"encode": [s], "score": [s],
    "device_ms": [ms], "encoded": [the waves' encoded rows]}``."""
    walls = {"encode": [], "score": [], "device_ms": [], "encoded": []}
    originals = (GQARunner._encode, ScoringMixin.score_rows)

    def encode(self, *a, **kw):
        t0 = time.perf_counter()
        out = originals[0](self, *a, **kw)
        walls["encode"].append(time.perf_counter() - t0)
        walls["encoded"].append(out)
        return out

    def score_rows(self, *a, **kw):
        out = []
        t0 = time.perf_counter()
        if profiled:
            walls["device_ms"].append(device_ms(lambda: out.append(originals[1](self, *a, **kw))))
        else:
            out.append(originals[1](self, *a, **kw))
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        walls["score"].append(time.perf_counter() - t0)
        return out[0]

    GQARunner._encode, ScoringMixin.score_rows = encode, score_rows
    try:
        yield walls
    finally:
        GQARunner._encode, ScoringMixin.score_rows = originals


def _decoder(n_rows: int, tmp: str) -> dict:
    path = os.path.join(tmp, "obj.tsv")
    nbytes = tsv.write_obj_tsv(path, random_obj_rows([36] * n_rows))
    walls = {}
    t0 = time.perf_counter()
    tsv.pack_obj_tsv(path, os.path.join(tmp, "pack"))
    walls["pack"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tsv.load_obj_tsv(path)  # the decoder alone, no pack written
    walls["decode"] = time.perf_counter() - t0
    mb = nbytes / 1e6
    res = {"rows": n_rows, "tsv_mb": mb, **{f"{k}_s": v for k, v in walls.items()},
           **{f"{k}_mb_per_s": mb / v for k, v in walls.items()}}
    print(f"decoder: {n_rows} rows, {mb:.1f} MB of TSV; pack {walls['pack']:.3f} s "
          f"({res['pack_mb_per_s']:.1f} MB/s); decoding alone {walls['decode']:.3f} s "
          f"({res['decode_mb_per_s']:.1f} MB/s)", flush=True)
    return res


def feed_walls(encoded, batch: int, device: str) -> tuple[float, float]:
    """The scoring loop's feed alone over ``encoded``: the host gather of
    every batch (``batch_iterator``), and the gather with the pinned copy
    to ``device`` (``device_prefetch``, synchronised); seconds."""
    t0 = time.perf_counter()
    for _ in batch_iterator(encoded, batch):
        pass
    gather = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in device_prefetch(batch_iterator(encoded, batch), device):
        pass
    if device == "cuda":
        torch.cuda.synchronize()
    return gather, time.perf_counter() - t0


def _throughput(name: str, argv: list, lines: list, on_card: bool, batch: int) -> dict:
    with timed_waves() as walls:
        out, _, window = serve.serve_lines(argv, lines)
    if len(out) != len(lines) or any('"error"' in line for line in out):
        raise AssertionError(f"{name}: {len(out)} lines for {len(lines)} records, or an error record")
    enc, score = sum(walls["encode"]), sum(walls["score"])
    gather, feed = feed_walls(walls["encoded"][0], batch, "cuda" if on_card else "cpu")
    res = {"records": len(lines), "waves": len(walls["score"]), "stream_s": window,
           "q_per_s": len(lines) / window, "encode_s": enc, "score_s": score, "gather_s": gather,
           "feed_s": feed, "device_ms": None, "profiled_score_s": None, "busy": None}
    if on_card:
        # A second run, the scoring loop alone under the profiler.
        with timed_waves(profiled=True) as prof:
            serve.serve_lines(argv, lines)
        res["device_ms"], res["profiled_score_s"] = sum(prof["device_ms"]), sum(prof["score"])
        res["busy"] = res["device_ms"] / 1e3 / score
    dev = "not measured" if res["device_ms"] is None else (
        f"{res['device_ms']:.3f} ms ({100 * res['busy']:.1f}% of the scoring loop; that loop "
        f"{1e3 * res['profiled_score_s']:.3f} ms under the profiler)")
    print(f"{name}: {len(lines)} records in {res['waves']} wave(s): {res['q_per_s']:.1f} q/s over "
          f"the stream's {1e3 * window:.3f} ms (encode {1e3 * enc:.3f} ms, scoring loop "
          f"{1e3 * score:.3f} ms); the scoring loop's device time {dev}; the feed alone: gather "
          f"{1e3 * gather:.3f} ms, gather + pinned copy {1e3 * feed:.3f} ms", flush=True)
    return res


def _latency(argv: list, lines: list, interval: float) -> dict:
    def arriving():
        for line in lines:
            yield line
            time.sleep(interval)

    with timed_waves() as walls:
        out, stats, _ = serve.serve_lines(argv + ["--serve_stats"], arriving())
    if len(out) != len(lines) or stats["count"] != len(lines):
        raise AssertionError(f"latency: {len(out)} lines, count {stats['count']}, for {len(lines)} records")
    waves = len(walls["score"])
    return dict(stats, waves=waves, encode_ms_per_wave=1e3 * sum(walls["encode"]) / waves,
                score_ms_per_wave=1e3 * sum(walls["score"]) / waves)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--latency_records", type=int, default=60)
    ap.add_argument("--interval", type=float, default=0.1)
    ap.add_argument("--latency_batches", type=int, nargs="+", default=[256, 8])
    ap.add_argument("--tsv_rows", type=int, default=512)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true", help="a 1-layer, 32-wide model (CPU checks)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("profile_serve runs on a CUDA card (--device cpu for a CPU check)")
    results = {"device": "cpu"}
    if on_card:
        results["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
        from rgqa_tpu_torch.ops._build import build_all

        build_all()
    print(f"profile_serve on {results['device']}", flush=True)
    size = (TINY if args.tiny else []) + ["--device", args.device]
    with tempfile.TemporaryDirectory(prefix="rgqa_profile_serve_") as tmp:
        results["decoder"] = _decoder(args.tsv_rows, tmp)
        root = os.path.join(tmp, "gqa")
        make_synthetic_gqa(root)
        with open(os.path.join(root, "testdev.json")) as f:
            rows = json.load(f)
        stream = serve_records(rows, args.records)
        base = ["--synthetic", "--data_root", root, "--test", "testdev", "--scorer", "msp", *size]
        for name, extra in (("lxmert", []), ("vilt", ["--backbone", "vilt"])):
            argv = base + extra + ["--batchSize", str(args.batch), "--wave_timeout", "0",
                                   "--output", os.path.join(tmp, f"out_{name}")]
            serve.serve_lines(argv, stream[: args.batch])  # first forwards: kernel loads, the allocator, ViLT's pack
            results[f"throughput_{name}"] = _throughput(f"throughput {name}, batch {args.batch}", argv,
                                                        stream, on_card, args.batch)
        for b in args.latency_batches:
            argv = base + ["--batchSize", str(b), "--output", os.path.join(tmp, f"lat_{b}")]
            stats = _latency(argv, stream[: args.latency_records], args.interval)
            results[f"latency_batch{b}"] = stats
            print(f"latency, batch {b}, one record every {args.interval} s, {stats['count']} records: "
                  f"p50 {stats['p50_ms']} ms, p95 {stats['p95_ms']} ms, p99 {stats['p99_ms']} ms, "
                  f"max {stats['max_ms']} ms; {stats['waves']} waves, per wave encode "
                  f"{stats['encode_ms_per_wave']:.3f} ms, scoring loop {stats['score_ms_per_wave']:.3f} ms",
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
