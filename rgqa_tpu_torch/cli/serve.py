"""Scoring service (port of ``rgqa_tpu/cli/serve.py``): JSONL questions in,
scored JSONL out.

Reads question records from stdin, one JSON object per line, answers and
rejection-scores them in waves (host encode: tokenize + RoI feature or
pixel lookup; then the scoring loop of ``eval.py``: pinned side-stream
prefetch, forward, lag-1 fetch) and writes one line per record:

    {"questionId": ..., "prediction": ..., "confidence": ...}

the ``compute_accfpr`` prediction contract (reference
``gqa_data.py:583-605``), confidence rounded to 4 dp.  A record needs
``question_id`` (or ``questionId``), ``sent`` and ``img_id`` (an image of
``<data_root>/features``, and for ViLT of its pixel source).  A bad
record is answered inline with ``{"record": ..., "error": ...}`` and
never stops the stream.  ``served N questions`` goes to stderr at the end.

It takes the JAX CLI's flags (the port's ``parse_cli``) and runs on the
card (``--device cuda``, the default; raises without one) unless given
``--device cpu``.  ``--test <split>`` names the answer vocabulary; ``--backbone`` is lxmert,
uniter, vilt or butd.  The
scorer is any that ``make_scorer`` builds (``--scorer`` msp, energy,
odin, maha, dropout, branched); the evaluate CLI's refusals hold (odin /
maha on ViLT and the caption matcher), and the gated scorers
(``separate``, ``caption``: two models) and ensembles (``--load a,b``)
are the evaluate CLI's.  ``--scorer clip``, ``match`` and ``frcnn`` are
refused by name: the JAX serve builds its scorer through ``make_scorer``,
which knows none of them (``ValueError: unknown scorer``,
``rgqa_tpu/scorers/__init__.py:75``); the evaluate CLI scores the first
two.  The runner is the evaluate CLI's (``evaluate.make_runner``): bf16
serving weights under bf16, but for ``maha`` f32 weights under bf16
compute, so the estimator that ``<output>/sample_estimates.pkl`` keeps
for every later serve or evaluate run is fitted from f32 weights (the JAX
serve casts the weights to bf16 before the fit,
``rgqa_tpu/cli/serve.py:177-180``).  BUTD is served in f32, as its
evaluate CLI scores it: the JAX serve's cast under ``--bf16`` rounds every
f32 leaf, BUTD's weights too (``rgqa_tpu/cli/serve.py:177-179``), though
its ``_build_butd`` keeps BUTD in f32 and its evaluate CLI never casts; a
port-vs-JAX serve comparison on BUTD must name that divergence.

Latency: ``--wave_timeout`` (default 50 ms) bounds how long a pending
record waits for its wave to fill (``_waves``); a lone record's wave
still runs a whole ``--batchSize`` forward (the batch is padded), so a
latency tier runs at a small ``--batchSize``.  ``--serve_stats`` prints
the per-record latency (arrival -> answer written) p50 / p95 / p99 as
one JSON line on stderr at the end.  Arrival times and answers are kept
by the record's place in its wave, so records that share a question id
each count once with their own latency and get their own answer (the JAX
serve keys both by question id, ``rgqa_tpu/cli/serve.py:198,213``).

Data parallel: under ``python -m torch.distributed.run --nproc_per_node N``
(``--device cpu``: N processes over gloo) rank 0 alone reads the input
and forms the waves on its own clock; it broadcasts each wave's lines to
the other ranks (then an end marker; an idle input sends an empty wave
every ``_KEEPALIVE_S`` so that no rank's wait reaches the group's time
limit).  Every rank parses the same lines and scores its rows of each
padded global batch (``--batchSize``, which the world must divide), the
outputs gathered in order; rank 0 alone prints the answers, the error
lines, ``served N`` and ``--serve_stats`` (latency on rank 0's clock).
``--scorer maha`` fits over the gathered train features and every rank
reads the estimator that rank 0 caches.

Example:
    printf '%s\\n' '{"question_id": "q1", "sent": "is there a car?", "img_id": "img00000"}' |
    python -m rgqa_tpu_torch.cli.serve --synthetic --data_root /tmp/gqa \\
        --test testdev --scorer msp --output /tmp/gqa_serve
"""

from __future__ import annotations

import contextlib
import io
import json
import queue as _queue
import sys
import threading
import time

from rgqa_tpu_torch.cli.evaluate import GATED_SCORERS, make_runner, refuse_unported
from rgqa_tpu_torch.config import parse_cli
from rgqa_tpu_torch.data.dataset import GQADataset
from rgqa_tpu_torch.parallel import broadcast_objects, check_batch_size, initialize_distributed, make_mesh

# Questions per scoring wave: batches enough for the feed's prefetch and
# the lag-1 fetch to reach steady state, few enough to bound latency and
# host memory.
_WAVE_BATCHES = 64
# Under several ranks: an idle input sends an empty wave this often, well
# inside the group's time limit (parallel/distributed.py's JOIN_SECONDS).
_KEEPALIVE_S = 60.0
# Scorers the JAX serve cannot build (its make_scorer knows none of them).
NOT_SERVED = ("clip", "match", "frcnn")


def _normalize(rec: dict) -> dict:
    qid = rec.get("question_id", rec.get("questionId"))
    if qid is None or "sent" not in rec or "img_id" not in rec:
        raise ValueError(f"record needs question_id/questionId, sent, img_id: {sorted(rec)}")
    return {"question_id": str(qid), "sent": rec["sent"], "img_id": rec["img_id"],
            "label": rec.get("label", {})}


def _waves(lines, wave_size, timeout: float = 0.0, idle: float | None = None):
    """Group raw input lines into waves of ``(line, t_arrival)`` pairs.

    A reader thread only queues the lines as they arrive (all torch work
    stays on the caller's thread).  A wave goes out when it is full, or
    when its oldest record has waited ``timeout`` seconds with the input
    idle, so a lone record never waits for ``wave_size`` peers;
    ``timeout=0`` waits for full waves.  ``idle``: an empty wave goes out
    after that many seconds without a record.  An error reading the input
    is raised on the consumer, after the wave that arrived before it."""
    q: _queue.Queue = _queue.Queue(maxsize=wave_size * 2)
    end = object()

    def reader():
        try:
            for line in lines:
                line = line.strip()
                if line:
                    q.put((line, time.perf_counter()))
        except BaseException as e:  # surface input errors on the consumer
            q.put(e)
            return
        q.put(end)

    threading.Thread(target=reader, daemon=True).start()
    wave: list = []
    while True:
        wait = None if wave else idle
        if wave and timeout > 0:
            wait = timeout - (time.perf_counter() - wave[0][1])
            if wait <= 0:
                yield wave
                wave = []
                continue
        try:
            item = q.get(timeout=wait)
        except _queue.Empty:
            if not wave:
                yield []  # idle: the keepalive
            continue  # else the oldest record timed out: dispatch at the loop top
        if item is end:
            break
        if isinstance(item, BaseException):
            if wave:
                yield wave  # serve what arrived before the input died
            raise item
        wave.append(item)
        if len(wave) >= wave_size:
            yield wave
            wave = []
    if wave:
        yield wave


class _LatencyStats:
    """Per-record service latency (arrival -> answer written)."""

    def __init__(self):
        self.samples: list = []

    def record(self, t_arrival: float):
        self.samples.append(time.perf_counter() - t_arrival)

    def summary(self) -> dict:
        import numpy as np

        if not self.samples:
            return {"count": 0}
        s = np.asarray(self.samples)
        return {
            "count": int(len(s)),
            "p50_ms": round(float(np.percentile(s, 50)) * 1e3, 2),
            "p95_ms": round(float(np.percentile(s, 95)) * 1e3, 2),
            "p99_ms": round(float(np.percentile(s, 99)) * 1e3, 2),
            "max_ms": round(float(s.max()) * 1e3, 2),
        }


def _parse(record: str, runner) -> dict:
    rec = json.loads(record)
    if not isinstance(rec, dict):
        raise ValueError("record must be a JSON object")
    row = _normalize(rec)
    img_id = row["img_id"]
    if img_id not in runner.features or (
        runner.image_source is not None and img_id not in runner.image_source
    ):
        raise KeyError(f"unknown img_id {img_id!r}")
    return row


def _shared_waves(mesh, waves):
    """Each wave's lines on every rank, beside their arrival times on
    rank 0 (None elsewhere): rank 0 reads ``waves`` and broadcasts each
    wave, then None at the end or on an input error, which rank 0 then
    raises."""
    while True:
        wave, error = None, None
        if mesh.is_main:
            try:
                wave = next(waves, None)
            except Exception as e:  # end the other ranks first
                error = e
        lines = broadcast_objects(mesh, None if wave is None else [line for line, _ in wave])
        if lines is None:
            if error is not None:
                raise error
            return
        yield lines, ([t for _, t in wave] if mesh.is_main else [None] * len(lines))


def main(argv=None, stdin=None, stdout=None) -> int:
    """Serve ``stdin`` (default ``sys.stdin``) to ``stdout``; returns the
    number of records answered (error records not counted)."""
    cfg, ns = parse_cli(argv)
    device = initialize_distributed(ns.device) or ns.device
    mesh = make_mesh(device)  # a rank launched without joining raises here
    check_batch_size(mesh, cfg.train.batch_size)
    main_rank = mesh.is_main
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    # --valid defaults to "valid", so --test is checked: the answer
    # vocabulary's split must be a deliberate choice in a deployment.
    if not cfg.data.test_splits:
        raise SystemExit("--test <split> is required (answer-vocabulary source)")
    if cfg.ood.scorer in NOT_SERVED:
        raise SystemExit(f"--scorer {cfg.ood.scorer} is not served: the JAX serve builds its scorer through "
                         "make_scorer, which has no such scorer; the evaluate CLI scores clip, match and frcnn")
    refuse_unported(cfg)
    if cfg.ood.scorer in GATED_SCORERS or (cfg.load and "," in cfg.load):
        raise SystemExit("--scorer separate and ensembles (--load a,b) are scored by the evaluate "
                         "CLI, as is --scorer caption; serve scores with one model")

    runner = make_runner(cfg, device, cfg.ood.scorer)
    scorer = runner.make_scorer()
    vocab = runner.dataset

    wave_size = cfg.train.batch_size * _WAVE_BATCHES
    stats = _LatencyStats() if ns.serve_stats and main_rank else None
    waves = _waves(stdin, wave_size, timeout=float(ns.wave_timeout or 0.0),
                   idle=_KEEPALIVE_S if mesh.world > 1 else None) if main_rank else None
    served = 0
    for lines, times in _shared_waves(mesh, waves):
        rows, arrivals = [], []
        for line, t_in in zip(lines, times):
            try:
                rows.append(_parse(line, runner))
                arrivals.append(t_in)
            except Exception as e:  # report, never stop the stream
                if main_rank:
                    print(json.dumps({"record": line, "error": str(e)}), file=stdout)
        if rows:
            ds = GQADataset.from_rows(rows, ans2label=vocab.ans2label, label2ans=vocab.label2ans,
                                      name="serve")
            answers = runner.score_rows(runner._encode(ds), scorer=scorer)
            for row, t_in, (ans, score) in zip(rows, arrivals, answers) if main_rank else ():
                print(json.dumps({"questionId": row["question_id"], "prediction": ans,
                                  "confidence": round(float(score), 4)}), file=stdout)
                if stats is not None:
                    stats.record(t_in)
            served += len(rows)
        if main_rank:
            stdout.flush()
    if main_rank:
        print(f"served {served} questions", file=sys.stderr)
    if stats is not None:
        print(json.dumps({"latency": stats.summary()}), file=sys.stderr)
    return served


class _ClockedOut(io.StringIO):
    """An output stream that keeps the time of its last write."""

    last = None

    def write(self, text):
        n = super().write(text)
        self.last = time.perf_counter()
        return n


def serve_lines(argv, lines) -> tuple[list, dict | None, float]:
    """:func:`main` in this process on ``lines`` (records without their
    newlines): returns the output lines, the ``--serve_stats`` latency
    dict (None without the flag) and the stream's window in seconds, from
    the first record's arrival (the reader thread taking it) to the last
    line written."""
    first = []

    def stdin():
        for line in lines:
            if not first:
                first.append(time.perf_counter())
            yield line + "\n"

    out, err = _ClockedOut(), io.StringIO()
    with contextlib.redirect_stderr(err):
        main(argv, stdin=stdin(), stdout=out)
    stats = [json.loads(line)["latency"] for line in err.getvalue().splitlines()
             if line.startswith('{"latency"')]
    window = out.last - first[0] if first and out.last is not None else 0.0
    return out.getvalue().splitlines(), (stats[0] if stats else None), window


if __name__ == "__main__":
    main()
