"""Where the time of a full-width LXMERT, UNITER, ViLT, BUTD, caption-
matcher or CLIP forward or training step goes on one CUDA card.

    python -m rgqa_tpu_torch.tools.profile_forward [--backbone uniter|vilt|butd|caps|clip]
        [--batch 256 32] [--iters 20] [--repeats 3] [--out FILE.json]
    python -m rgqa_tpu_torch.tools.profile_forward --train [--backbone uniter|vilt|butd|caps]
        [--batch 32] [--mixup_mode MODE [--mixup_beta B] | --branched] [--out FILE.json]
    python -m rgqa_tpu_torch.tools.profile_forward --train --strategy
        adv|resampling|woods|distill_online|weight [--batch 32] [--out FILE.json]
    python -m rgqa_tpu_torch.tools.profile_forward --train --strategy weight
        --update_weight_model [--fp32] [--batch 32] [--out FILE.json]
    python -m rgqa_tpu_torch.tools.profile_forward --scorers [NAME ...] [--backbone uniter]
        [--batch 256] [--out FILE.json]
    python -m rgqa_tpu_torch.tools.profile_forward --backbone uniter --text_len 40
        (--train | --scorers dropout) [--out FILE.json]
    python -m rgqa_tpu_torch.tools.profile_forward --pretrain [--batch 256] [--out FILE.json]
    python -m rgqa_tpu_torch.tools.profile_forward --vqa [--batch 32] [--out FILE.json]

Builds ``LxmertForGQA`` (or, with ``--backbone uniter``, UNITER-base over
its 56-token stream, or with ``--backbone vilt``, ViLT-B/32 with
40-token text, a 185-token stream) at full width
(``zoo.default_config``) in bf16 from seed 0 and, for each batch size of
``zoo.example_batch``, runs the forward through the attention kernels
and through the plain version.
With ``--train`` it runs training steps instead (f32 master weights,
bf16 compute, RP pairing, BertAdam, dropout 0.1 and 0, kernels and
plain versions); ViLT trains on the train CLI's 20-token text, a
165-token stream, on the u8 pixel wire with padded rects.  BUTD
(``--backbone butd``: GloVe-300, GRU-1024 over 40 tokens, 36 RoIs, 1842
answers; f32 weights and products whatever the run's ``--bf16``) has no
attention kernel: its two routes are ``f32``, as it ships (no TF32 in
cuDNN's GRU or cuBLAS), and ``tf32``, the same call with TF32 allowed
in both, which prices the exact products; its training step is RP at
the model's own dropouts (0.2 / 0.5).  The caption matcher (``--backbone
caps``: BERT-base over 20 tokens) runs bf16 like the others, and its
training step is the caption strategy's (no RP; the binary loss
against the answerable indicator; dropout 0.1 and 0).  The strategy
flags swap RP for the train CLI's step with them, as
``scripts/lxmert/train/{mixup,branched}.sh`` run it (no RP):
``--mixup_mode`` with ``--mixup_beta`` (the rows doubled by the
pseudo-UQ rows) or ``--branched`` (LXMERT's confidence head and the
branched loss).  ``--strategy`` runs LXMERT's step of one of the
strategies with a step of their own (``tools/strategy_steps.py``: VILLA,
the min-max pair of forwards on two batches, online distillation with a
second full-width model in eval mode as the teacher, the CLIP-weighted
pairs; batch 32); with ``--update_weight_model`` the joint step of
``weight --update_weight_model`` beside a full-width ViT-B/32 CLIP
trained with it (bf16 compute over f32 weights, or under ``--fp32`` f32
products without TF32 in both models), plus the CLIP side alone (its
cosine forward and backward, no optimizer) to price its share.  CLIP
(``--backbone clip``: ViT-B/32 at 224 px, 50 tokens through #1, and the
12 x 512 causal text tower over 77 tokens, plain attention) runs one
scorer forward, the normalize of uint8 pixels on the card and both
towers to the image-question cosine, in f32 without TF32, as the CLIP
scorer ships (``models.clip.example_inputs``: texts of 4-20 tokens);
its routes are ``kernel`` and ``plain``.  With
``--scorers`` it runs one scorer call per batch of full-width LXMERT
(bf16 serving weights), kernels and plain versions: msp, energy, ODIN
(T 1e5, noise 1e-4), Mahalanobis un-noised and noised (1e-2; the
estimator fitted on four batches of pooled features with one-hot
targets over 16 answers) and MC-dropout (seeds 0-4, dropout 0.1);
names after ``--scorers`` (msp, energy, odin, maha, "maha noised",
dropout) pick some, and ``--backbone uniter`` scores full-width UNITER
instead.  ``--text_len N`` sets the model's ``max_text_len`` (UNITER
with 40-token questions attends over 76 tokens, the long dropout pair's
stream: 12 4L and 12 5L a training step, 12 4L an MC-dropout pass),
with each row's question cut to a random length of 4-N tokens, as the
synthetic split encodes them.
``--pretrain`` runs the LXMERT pretraining step (``LxmertPretraining``
with the reference's 9500-answer QA head, all six tasks, one set of
host-drawn masks with BERT's special ids; batch 256, as
``scripts/lxmert/train/pretrain.sh``) and ``--vqa`` the VQA fine-tuning
step (LXMERT with VQA v2's 3129-answer head, BCE over soft targets, no
RP; batch 32, as ``scripts/vqa/train/vanilla.sh``), each at dropout 0.1
and 0, kernels and plain.  For each run:

- wall per forward: the best of ``--repeats`` means over ``--iters``
  forwards, synchronised at both ends, for every run before the first
  profile;
- device time per forward by kernel class, from ``torch.profiler`` over
  ``--iters`` forwards (CUDA kernel, memcpy and memset events, summed;
  one stream, so they do not overlap), and the busy share, device time
  over wall.

Prints one table per run and, given ``--out``, writes every number to it as JSON.
Raises if there is no card or the profiler records no device time.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import time
from collections import defaultdict

import torch

from rgqa_tpu_torch.config import OptimConfig
from rgqa_tpu_torch.data.batching import to_device
from rgqa_tpu_torch.device import exact_f32
from rgqa_tpu_torch.models.zoo import build_model, default_config, example_batch
from rgqa_tpu_torch.ops import attention as att

# (class, substrings of the lower-cased kernel name), first match wins.
KERNEL_CLASSES = (
    ("recurrent (cuDNN)", ("rnn", "gru")),  # BUTD's GRU
    ("attention backward", ("fused_attention_bwd", "long_bwd", "fused_attention_dbias")),
    ("attention kernel", ("fused_attention",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "wgmma")),
    ("layer norm", ("layer_norm",)),
    ("gelu", ("gelu",)),
    ("softmax", ("softmax",)),
    ("weight concat", ("catarray",)),
    ("copy / cast", ("copy",)),
    ("optimizer (foreach)", ("multi_tensor",)),
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
    us, count, other = defaultdict(float), defaultdict(int), defaultdict(float)
    for evt in prof.events():
        # A GPU-side user annotation (e.g. the range "Optimizer.step#...")
        # spans kernels that are counted on their own.
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            cls = classify(evt.name)
            us[cls] += evt.time_range.elapsed_us()
            count[cls] += 1
            if cls == OTHER:
                other[evt.name] += evt.time_range.elapsed_us()
    if not us:
        raise RuntimeError("torch.profiler recorded no device time")
    top = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    print("    largest kernels of class other (ms per profiled call): " + "; ".join(
        f"{ms / 1e3 / iters:.3f} {name[:90]}" for name, ms in top))
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


def _print_run(run: dict, unit: str = "forward") -> None:
    print(f"batch {run['batch']}, {run['route']}: wall {run['wall_ms']:.3f} ms per {unit} "
          f"({run['questions_per_s']:.1f} q/s), device {run['device_ms']:.3f} ms "
          f"({100 * run['busy_share']:.1f}% busy), {run['launches']:.0f} device launches, "
          f"{run['attention_launches']} through the attention kernels")
    for cls, c in run["classes"].items():
        print(f"    {cls:<18} {c['ms']:8.3f} ms  {100 * c['share']:5.1f}%  {c['launches']:6.0f} launches")


@contextlib.contextmanager
def _tf32():
    """TF32 allowed in cuDNN and cuBLAS for the block (BUTD's ``tf32``
    route), the switches as they were after it."""
    cudnn, precision = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(precision)


def _with_tf32(model, fn):
    """``fn`` run with BUTD ``model``'s precision context swapped for
    :func:`_tf32` (its forward's and, through the adapter, a training
    step's backward)."""

    def run():
        model.precision = _tf32
        try:
            return fn()
        finally:
            model.precision = exact_f32

    return run


def _strategy_cases(sizes, name: str) -> dict:
    """{(batch, "dropout d kernels" | "dropout d plain"): one step of
    ``name`` (``tools/strategy_steps.py``)} on full-width LXMERT (f32
    masters, bf16 compute); the teacher of ``distill_online``, a second
    LXMERT with bf16 weights in eval mode."""
    import dataclasses

    import numpy as np

    from rgqa_tpu_torch.ops.dropout import DropoutRng
    from rgqa_tpu_torch.tools.strategy_steps import make_strategy_step, strategy_inputs
    from rgqa_tpu_torch.train.optimizer import make_optimizer

    base = default_config()
    teacher_forward = None
    if name == "distill_online":
        _, teacher_forward = build_model(base, use_bf16=True, device="cuda",
                                         generator=torch.Generator(device="cuda").manual_seed(2))
    cases = {}
    for dropout in (0.1, 0.0):
        cfg = dataclasses.replace(base, encoder=dataclasses.replace(
            base.encoder, hidden_dropout=dropout, attention_dropout=dropout))
        model, forward = build_model(cfg, use_bf16=True, device="cuda", train=True,
                                     generator=torch.Generator(device="cuda").manual_seed(0))
        opt = make_optimizer(OptimConfig(), model.parameters(), t_total=10**6)
        rng = DropoutRng(device=torch.Generator(device="cuda").manual_seed(1),
                         host=torch.Generator().manual_seed(1))
        for size in sizes:
            batches = []
            for seed in (0, 1):
                batch = example_batch(cfg, size, seed=seed)
                target = np.zeros((size, cfg.num_answers), np.float32)
                target[np.arange(size), (np.arange(size) + seed) % cfg.num_answers] = 1.0
                id_mask = (np.arange(size) % 3 != 0).astype(np.float32)  # a third unanswerable
                target[id_mask == 0] = 0.0
                batch.update(target=target, id_mask=id_mask)
                batches.append(to_device(batch, "cuda"))
            args = strategy_inputs(name, batches)[0]
            for fused, route in ((None, "kernels"), (False, "plain")):
                step = make_strategy_step(name, forward, opt, rng=rng, use_fused=fused,
                                          teacher_forward=teacher_forward)
                cases[(size, f"dropout {dropout} {route}")] = functools.partial(step, *args)
    return cases


def _weight_model_cases(sizes, fp32: bool) -> dict:
    """{(batch, "dropout d kernels" | "dropout d plain" | "clip side"): one
    joint step of ``weight --update_weight_model``} on full-width LXMERT
    and a full-width ViT-B/32 CLIP (f32 weights; bf16 compute unless
    ``fp32``), and the CLIP side alone: the cosine's forward and backward
    through the kernels."""
    import dataclasses

    import numpy as np

    from rgqa_tpu_torch.models.clip import ClipConfig, ClipModel, init_clip_weights
    from rgqa_tpu_torch.ops.dropout import DropoutRng
    from rgqa_tpu_torch.ops.pixels import clip_normalize
    from rgqa_tpu_torch.tools.strategy_steps import make_strategy_step, strategy_inputs, with_clip_inputs
    from rgqa_tpu_torch.train.optimizer import make_optimizer

    base, ccfg = default_config(), ClipConfig()
    dtype = torch.float32 if fp32 else torch.bfloat16
    with torch.device("cuda"):
        clip_model = ClipModel(ccfg, dtype)
    init_clip_weights(clip_model, torch.Generator(device="cuda").manual_seed(3))
    cases = {}
    for dropout in (0.1, 0.0):
        cfg = dataclasses.replace(base, encoder=dataclasses.replace(
            base.encoder, hidden_dropout=dropout, attention_dropout=dropout))
        model, forward = build_model(cfg, use_bf16=not fp32, device="cuda", train=True,
                                     generator=torch.Generator(device="cuda").manual_seed(0))
        opt = make_optimizer(OptimConfig(), model.parameters(), t_total=10**6)
        rng = DropoutRng(device=torch.Generator(device="cuda").manual_seed(1),
                         host=torch.Generator().manual_seed(1))
        for size in sizes:
            batch = example_batch(cfg, size, seed=0)
            target = np.zeros((size, cfg.num_answers), np.float32)
            target[np.arange(size), np.arange(size) % cfg.num_answers] = 1.0
            batch = with_clip_inputs(to_device(dict(batch, target=target), "cuda"), ccfg)
            args = strategy_inputs("weight_model", [batch])[0]
            for fused, route in ((None, "kernels"), (False, "plain")):
                step = make_strategy_step("weight_model", forward, opt, rng=rng, use_fused=fused,
                                          clip_model=clip_model)
                cases[(size, f"dropout {dropout} {route}")] = functools.partial(step, *args)
            if dropout == 0.0:
                def clip_side(b=batch):
                    with exact_f32() if fp32 else contextlib.nullcontext():
                        cos = clip_model.cosine(b["clip_ids"], b["clip_mask"], clip_normalize(b["clip_pixels"]))
                        cos.sum().backward()
                    clip_model.zero_grad(set_to_none=True)

                cases[(size, "clip side")] = clip_side
    return cases


def _config(backbone: str, text_len):
    """The full-width config of ``backbone``, at ``text_len`` when given."""
    import dataclasses

    cfg = default_config(backbone)
    return cfg if text_len is None else dataclasses.replace(cfg, max_text_len=text_len)


def _padded_text(batch: dict, seed: int = 1) -> dict:
    """``batch`` with each row's question cut to a random length of 4-T
    tokens (pad ids 0, mask 0 past it), as the synthetic split's encodings."""
    import numpy as np

    ids, mask = batch["input_ids"].copy(), batch["input_mask"].copy()
    b, t = ids.shape
    pad = np.arange(t)[None, :] >= np.random.default_rng(seed).integers(4, t + 1, b)[:, None]
    ids[pad], mask[pad] = 0, 0
    return dict(batch, input_ids=ids, input_mask=mask)


def _example(cfg, size: int, text_len, **kw) -> dict:
    batch = example_batch(cfg, size, seed=0, **kw)
    return batch if text_len is None else _padded_text(batch)


def _train_cases(sizes, backbone: str, strategy: dict = None, text_len=None) -> dict:
    """{(batch, "dropout d kernels" | "dropout d plain"): one training
    step}, each on its own full-width model (f32 masters, bf16 compute);
    ``strategy``, the step's mixup or branched options, replaces RP."""
    import dataclasses

    import numpy as np

    from rgqa_tpu_torch.ops.dropout import DropoutRng
    from rgqa_tpu_torch.train.optimizer import make_optimizer
    from rgqa_tpu_torch.train.step import make_train_step

    base = _config(backbone, text_len)
    if backbone == "vilt":
        base = dataclasses.replace(base, max_text_len=20)  # the train CLI's stream
    binary = backbone == "caps"  # the caption strategy: one logit, no RP
    if binary:
        base = dataclasses.replace(base, num_answers=1)
    strategy = strategy or {}
    base = dataclasses.replace(base, branched=strategy.get("branched", False))
    cases = {}
    # BUTD's dropouts are the model's own (0.2 / 0.5): one model.
    for dropout in (0.1, 0.0) if backbone != "butd" else (None,):
        cfg = base if dropout is None else dataclasses.replace(base, encoder=dataclasses.replace(
            base.encoder, hidden_dropout=dropout, attention_dropout=dropout))
        model, forward = build_model(
            cfg, use_bf16=True, device="cuda", train=True,
            generator=torch.Generator(device="cuda").manual_seed(0),
        )
        opt = make_optimizer(OptimConfig(), model.parameters(), t_total=10**6)
        rng = DropoutRng(device=torch.Generator(device="cuda").manual_seed(1),
                         host=torch.Generator().manual_seed(1))
        for size in sizes:
            batch = _example(cfg, size, text_len, pixel_wire="u8")
            target = np.zeros((size, cfg.num_answers), np.float32)
            target[np.arange(size), np.arange(size) % cfg.num_answers] = 1.0
            id_mask = (np.arange(size) % 3 != 0).astype(np.float32)  # a third unanswerable
            batch.update(target=target, id_mask=id_mask)
            batch = to_device(batch, "cuda")
            label = "model's dropout" if dropout is None else f"dropout {dropout}"

            steps = {fused: functools.partial(make_train_step(
                forward, opt, sample_pair=not (binary or strategy), binary=binary, rng=rng, use_fused=fused,
                **strategy), batch) for fused in (None, False)}
            if backbone == "butd":
                cases[(size, f"{label} f32")] = steps[None]
                cases[(size, f"{label} tf32")] = _with_tf32(model, steps[None])
            else:
                cases[(size, f"{label} kernels")] = steps[None]
                cases[(size, f"{label} plain")] = steps[False]
    return cases


PRETRAIN_ANSWERS = 9500  # the reference pretraining's QA head
VQA_ANSWERS = 3129  # VQA v2's answer vocabulary in the reference
BERT_SPECIALS, BERT_MASK = (0, 100, 101, 102, 103), 103  # [PAD] [UNK] [CLS] [SEP] [MASK] in BERT's vocabulary


def _pretrain_cases(sizes) -> dict:
    """{(batch, "dropout d kernels" | "dropout d plain"): one pretraining
    step} on full-width ``LxmertPretraining`` (f32 masters, bf16 compute),
    all six tasks, one set of masks per batch size."""
    import dataclasses

    import numpy as np

    from rgqa_tpu_torch.models.lxmert import LxmertPretraining
    from rgqa_tpu_torch.models.zoo import init_weights
    from rgqa_tpu_torch.ops.dropout import DropoutRng
    from rgqa_tpu_torch.pretrain import draw_pretrain_masks
    from rgqa_tpu_torch.pretrain.trainer import ALL_TASKS, make_pretrain_step
    from rgqa_tpu_torch.train.optimizer import make_optimizer

    base = default_config()
    cases = {}
    for dropout in (0.1, 0.0):
        enc = dataclasses.replace(base.encoder, hidden_dropout=dropout, attention_dropout=dropout)
        with torch.device("cuda"):
            model = LxmertPretraining(enc, PRETRAIN_ANSWERS, dtype=torch.bfloat16)
        init_weights(model, torch.Generator(device="cuda").manual_seed(0))
        opt = make_optimizer(OptimConfig(), model.parameters(), t_total=10**6)
        rng = DropoutRng(device=torch.Generator(device="cuda").manual_seed(1),
                         host=torch.Generator().manual_seed(1))
        for size in sizes:
            batch = example_batch(base, size, seed=0)
            rows = np.random.default_rng(1)
            batch.update(obj_id=rows.integers(0, 1600, (size, 36)).astype(np.int32),
                         attr_id=rows.integers(0, 400, (size, 36)).astype(np.int32),
                         ans=rows.integers(-1, PRETRAIN_ANSWERS, size).astype(np.int32))
            batch = to_device(batch, "cuda")
            draws = draw_pretrain_masks(batch, ALL_TASKS, vocab_size=enc.vocab_size,
                                        generator=torch.Generator().manual_seed(2))
            for fused, route in ((None, "kernels"), (False, "plain")):
                step, _ = make_pretrain_step(model, opt, mask_id=BERT_MASK, special_ids=BERT_SPECIALS, rng=rng,
                                             use_fused=fused)
                cases[(size, f"dropout {dropout} {route}")] = functools.partial(step, batch, draws)
    return cases


def _vqa_cases(sizes) -> dict:
    """{(batch, "dropout d kernels" | "dropout d plain"): one VQA step}:
    full-width LXMERT over ``VQA_ANSWERS`` answers (f32 masters, bf16
    compute), BCE x answers over soft targets (two answers a row, scores
    1.0 and 0.3), no RP."""
    import dataclasses

    import numpy as np

    from rgqa_tpu_torch.ops.dropout import DropoutRng
    from rgqa_tpu_torch.train.optimizer import make_optimizer
    from rgqa_tpu_torch.train.step import make_train_step

    base = dataclasses.replace(default_config(), num_answers=VQA_ANSWERS)
    cases = {}
    for dropout in (0.1, 0.0):
        cfg = dataclasses.replace(base, encoder=dataclasses.replace(
            base.encoder, hidden_dropout=dropout, attention_dropout=dropout))
        model, forward = build_model(cfg, use_bf16=True, device="cuda", train=True,
                                     generator=torch.Generator(device="cuda").manual_seed(0))
        opt = make_optimizer(OptimConfig(), model.parameters(), t_total=10**6)
        rng = DropoutRng(device=torch.Generator(device="cuda").manual_seed(1),
                         host=torch.Generator().manual_seed(1))
        for size in sizes:
            batch = example_batch(cfg, size, seed=0)
            target = np.zeros((size, VQA_ANSWERS), np.float32)
            target[np.arange(size), np.arange(size) % VQA_ANSWERS] = 1.0
            target[np.arange(size), (np.arange(size) + 7) % VQA_ANSWERS] = 0.3
            batch = to_device(dict(batch, target=target), "cuda")
            for fused in (None, False):
                step = make_train_step(forward, opt, rng=rng, use_fused=fused)
                cases[(size, f"dropout {dropout} {'kernels' if fused is None else 'plain'}")] = functools.partial(
                    step, batch)
    return cases


SCORERS = (("msp", "msp", {}), ("energy", "energy", {}), ("odin", "odin", {}), ("maha", "maha", {}),
           ("maha noised", "maha", {"noise": 1e-2}), ("dropout", "dropout", {}))


def _scorer_cases(sizes, backbone: str = "lxmert", names=(), text_len=None) -> dict:
    """{(batch, "<scorer> kernels" | "<scorer> plain"): one scorer call}
    on one full-width model (LXMERT unless ``backbone``) with bf16
    serving weights; the scorers in ``names``, all when empty."""
    from rgqa_tpu_torch.scorers import fit_estimator, make_scorer

    unknown = set(names) - {n for n, _, _ in SCORERS}
    if unknown:
        raise SystemExit(f"profile_forward: unknown scorers {sorted(unknown)}")
    cfg = _config(backbone, text_len)
    _, forward = build_model(cfg, use_bf16=True, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(0))
    plain = functools.partial(forward, use_fused=False)

    def fit_batches(size):
        gen = torch.Generator(device="cuda").manual_seed(2)
        for i in range(4):
            batch = to_device(example_batch(cfg, size, seed=1 + i), "cuda")
            with torch.no_grad():
                pooled = forward(batch, deterministic=True)["pooled"]
            target = torch.zeros((size, cfg.num_answers), device="cuda")
            target[torch.arange(size, device="cuda"),
                   torch.randint(0, 16, (size,), device="cuda", generator=gen)] = 1.0
            yield pooled, target

    cases = {}
    chosen = [c for c in SCORERS if not names or c[0] in names]
    for size in sizes:
        est = (fit_estimator(fit_batches(size), cfg.num_answers, cfg.encoder.hidden_size)
               if any(kind == "maha" for _, kind, _ in chosen) else None)
        batch = to_device(_example(cfg, size, text_len), "cuda")
        for name, kind, extra in chosen:
            for route, fwd in (("kernels", forward), ("plain", plain)):
                scorer = make_scorer(kind, fwd, estimator=est, seed_list=(0, 1, 2, 3, 4), **extra)
                cases[(size, f"{name} {route}")] = functools.partial(scorer, batch)
    return cases


def _clip_cases(sizes) -> dict:
    """{(batch, "kernel" | "plain"): one CLIP scorer forward} on a
    full-width ViT-B/32 CLIP, f32, seeded."""
    from rgqa_tpu_torch.models.clip import ClipConfig, ClipModel, example_inputs, init_clip_weights
    from rgqa_tpu_torch.ops.pixels import clip_normalize

    cfg = ClipConfig()
    with torch.device("cuda"):
        model = ClipModel(cfg)
    init_clip_weights(model, torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    cases = {}
    for size in sizes:
        ids, mask, u8 = (torch.from_numpy(a).cuda() for a in example_inputs(cfg, size, seed=0))
        for route, fused in (("kernel", None), ("plain", False)):
            cases[(size, route)] = functools.partial(
                lambda i, m, px, f: model.cosine(i, m, clip_normalize(px), use_fused=f), ids, mask, u8, fused)
    return cases


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=None,
                    help="batch sizes (default 256 32; with --train 32, doubled by RP)")
    ap.add_argument("--backbone", choices=("lxmert", "uniter", "vilt", "butd", "caps", "clip"),
                    default="lxmert")
    ap.add_argument("--train", action="store_true", help="profile training steps")
    ap.add_argument("--scorers", nargs="*", default=None, metavar="NAME",
                    help="profile the rejection scorers (all, or those named)")
    ap.add_argument("--text_len", type=int, default=None,
                    help="the model's max_text_len (UNITER at 40: a 76-token stream)")
    ap.add_argument("--pretrain", action="store_true", help="profile the LXMERT pretraining step")
    ap.add_argument("--vqa", action="store_true", help="profile the VQA fine-tuning step")
    ap.add_argument("--mixup_mode", default=None, help="with --train: the mixup / TreeMix step, no RP")
    ap.add_argument("--mixup_beta", type=float, default=1.0)
    ap.add_argument("--branched", action="store_true", help="with --train: the branched loss, no RP")
    ap.add_argument("--strategy", default=None,
                    choices=("adv", "resampling", "woods", "distill_online", "weight"),
                    help="with --train: that strategy's own step (LXMERT)")
    ap.add_argument("--update_weight_model", action="store_true",
                    help="with --train --strategy weight: the joint step that trains CLIP too")
    ap.add_argument("--fp32", action="store_true", help="with --update_weight_model: f32 compute")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write every number to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch {torch.__version__}")
    if args.train and args.strategy == "weight" and args.update_weight_model:
        return _profile(_weight_model_cases(args.batch or [32], args.fp32), args, smi, args.out, unit="step")
    if args.train and args.strategy:
        return _profile(_strategy_cases(args.batch or [32], args.strategy), args, smi, args.out, unit="step")
    if args.train:
        strategy = ({"mixup_mode": args.mixup_mode, "mixup_beta": args.mixup_beta} if args.mixup_mode
                    else {"branched": True} if args.branched else {})
        return _profile(_train_cases(args.batch or [32], args.backbone, strategy, args.text_len), args, smi,
                        args.out, unit="step")
    if args.scorers is not None:
        return _profile(_scorer_cases(args.batch or [256], args.backbone, args.scorers, args.text_len), args,
                        smi, args.out, unit="scorer call")
    if args.pretrain:
        return _profile(_pretrain_cases(args.batch or [256]), args, smi, args.out, unit="step")
    if args.vqa:
        return _profile(_vqa_cases(args.batch or [32]), args, smi, args.out, unit="step")

    if args.backbone == "clip":
        with torch.inference_mode():
            return _profile(_clip_cases(args.batch or [256, 32]), args, smi, args.out, unit="forward")
    cfg = _config(args.backbone, args.text_len)
    model, forward = build_model(
        cfg, use_bf16=True, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0),
    )
    fns = {}
    for size in args.batch or [256, 32]:
        batch = to_device(_example(cfg, size, args.text_len), "cuda")
        call = functools.partial(forward, batch)
        if args.backbone == "butd":
            fns[(size, "f32")], fns[(size, "tf32")] = call, _with_tf32(model, call)
        else:
            fns[(size, "kernel")] = call
            fns[(size, "plain")] = functools.partial(forward, batch, use_fused=False)
    with torch.inference_mode():
        return _profile(fns, args, smi, args.out, unit="forward")


def _attention_launches() -> int:
    return sum(fn.launches for fn in (
        att.fused_attention_cuda, att.fused_attention_long_cuda, att.fused_attention_bwd_cuda,
        att.fused_attention_long_bwd_cuda, att.fused_attention_dropout_cuda,
        att.fused_attention_dropout_bwd_cuda, att.fused_attention_dropout_long_cuda,
        att.fused_attention_dropout_long_bwd_cuda))


def _profile(fns: dict, args, smi: str, out: str, *, unit: str) -> list:
    walls = {}
    runs = []
    for case, fn in fns.items():
        for _ in range(3):  # warm-up: cuBLAS heuristics, allocator
            fn()
        before = _attention_launches()
        fn()
        torch.cuda.synchronize()
        per_call = _attention_launches() - before
        walls[case] = (per_call, _wall_ms(fn, args.iters, args.repeats))
    # Every wall is taken before the first profile: launches from the
    # host run slower once the profiler has been on.
    for case, fn in fns.items():
        runs.append(_summary(*case, *walls[case], _device_time(fn, args.iters)))
        _print_run(runs[-1], unit)
    first = next(iter(fns))
    after = _wall_ms(fns[first], args.iters, args.repeats)
    print(f"batch {first[0]}, {first[1]}: wall {after:.3f} ms per {unit} after the "
          f"profiles, {walls[first][1]:.3f} ms before")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({"device": smi, "torch": torch.__version__, "unit": unit, "runs": runs,
                       "first_wall_after_profiles_ms": after}, f, indent=1)
    return runs


if __name__ == "__main__":
    main()
