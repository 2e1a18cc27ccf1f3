#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rgqa_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or a few each; any failure raises, so the exit code is
nonzero:

1. device: the card's name and ``nvidia-smi``'s name and power limit;
   TF32 is turned off for matmuls and convolutions.  No CUDA -> exit 1.
2. build: compiles the eight sources of ``rgqa_tpu_torch/csrc`` for sm_90a,
   one nvcc each, side by side (prints each build time and ptxas' report).
   Since slice 9 the head-fold kernel's bf16 body (6d) runs on ``wgmma``:
   one line gives each of its instances' registers, spills and shared
   memory (static from ptxas, dynamic from the window's layout), and,
   where the toolkit has ``cuobjdump``, each instance's count of
   ``HGMMA`` instructions in its SASS (an instance the experiment's
   shapes use with none fails the phase).  #2's bf16 body
   (``fused_attention_long_wgmma<kWG>``, kWG warpgroups a block) runs on
   ``wgmma`` too: the same line for each of its instances, and an
   instance without HGMMA fails the phase.  Since slice 13 so does the
   epilogue's bf16 body (``epilogue_bf16<kNP>``, kNP keys in a window):
   the same line for each instance, and an instance without
   HGMMA or with spilled registers fails the phase.
3. kernels: the six attention kernels against their plain PyTorch
   versions.  #2, the long-stream forward, and #3L, the long-stream
   backward (given #2's row statistics), at ViLT-B/32's shapes (165x165,
   185x185, and 65x185 / 185x65 for ragged query tiles), either side of
   256 keys where #2's f32 body changes (20x256, 256x256, 20x257,
   257x257; the bf16 body walks key tiles of 64 at every length) and
   beyond (277x277: a 512 px image; 597x597, 20x597, 597x20: 16 px
   patches), at batch 256 (64 at 597 tokens) and 7, f32 and bf16, with
   pad-patch style masks (padded text, trailing keys masked) and one
   fully masked row, bounds as #1's and #3's; #2 with its row statistics
   gives the same output bits as without, and in f32 their log-sum-exp is
   within 1e-5 + 1e-7 |lse| of the plain scores'; #3L's two runs are
   equal bit for bit.  The other four at
   LXMERT's four attention shapes (20x20, 36x36, 20x36,
   36x20; 12 heads of 64), batch 256, 64 (a training step's 32 + RP rows)
   and 7, with one fully masked row:
   #1 forward (bound 2e-5 in f32), #3 backward, #4 dropout forward and #5
   dropout backward at rate 0.1 (bounds 1e-4 in f32; dbias from bf16
   inputs 1e-3 + 1e-4 |plain|); two runs of each at 36x36 give identical
   bits.  bf16 bound: 3e-2 + 1e-2 |plain| (the
   kernels round P and dS to bf16 where the plain versions keep f32; the
   relative term is one bf16 step of values above 4).  Rate 0 of #4 / #5
   equals #1 / #3 bit for bit; ``<g, out> == <dv, v>`` at rate 0.1 in f32
   (within 2e-3 relative; bf16 rounds P_drop and the output); the
   mask #4 applies, read out through a one-hot V, equals
   ``dropout_keep_mask_ref`` bit for bit, and its kept fraction at batch
   256 is within 5 sigma of (256 - t) / 256.  Per-call CUDA-event times of
   each kernel, its plain version and the one PyTorch call that computes
   the same function (``scaled_dot_product_attention``: forward; forward
   plus backward less forward; with ``dropout_p``), at batch 256 (#3 and
   #5, and since slice 8 #1 and #4, in bf16 at batch 64 too; #2 and
   #3L at 165, 185 and 277 tokens, batch 256, and 597 tokens, batch 64;
   #3L in bf16 only: its f32 body is checked, not timed).  Slice 8
   redesigned #1 / #4's bf16 body (one pass in registers, the dropout
   mask drawn once per 16 keys): the checks above hold it as they held
   the first design, #1 and #4 are timed at batch 64 in bf16 too, and
   two runs of #1 and #4 at 36x36 give identical bits as well.
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
12. vilt beyond 256 tokens (slice 6), full width: the evaluate CLI at
   ``--vilt_image_size 512`` (277 tokens), checked and re-scored as phase
   7, through #2 alone, 12 launches per forward; the train CLI at
   ``--vilt_patch_size 16`` (597 tokens), checked as phase 11 (12
   launches of #2 and 12 of #3L per step, none else); two dropout-0 steps
   at 597 tokens through the kernels and through the plain versions,
   losses within ``LOSS_RTOL``, ms per step of each (in turns).
13. experiments (slice 5): the four kernels of the experiment entry
   points, ``dual_pair`` (6e), ``cat_call`` (6f), ``headfold`` (6d) and
   ``epi_fused`` (6c), each against its plain version at the
   experiments' shapes (the cross and self pairs of 20 and 36 tokens;
   cat at 56 tokens split at 20 in xor and diag mode; headfold at 56x56,
   36x36, 20x36, 36x20, 20x20 with every (variant, F); the epilogue at
   LXMERT's four shapes and 7x36, a short query that spans ten batch rows
   a block), batch 384 and 7, f32 and bf16, with padded keys
   (-10000) and one fully masked row: bounds 2e-5 in f32 (1e-4 for the
   epilogue, a LayerNorm over sums in another order) and ``3e-2 + 1e-2
   |plain|`` in bf16.  Then each against the shipped composition: dual
   equals two #1 calls bit for bit (the same body, slice 8's one-pass
   body in bf16; cat runs it too, its term through the body's Mask
   parameter), cat/xor the two cross
   calls and cat/diag the two self calls, headfold #1 at every F, the
   epilogue ``split`` (#1, ``addmm``, residual, LayerNorm), within twice
   the bounds (each side lies within them of the plain version).  Slice
   9 redesigned headfold's bf16 body (``wgmma``, each tile of whole heads'
   stacked query rows against those heads' keys): these checks hold it as
   they held the first design, and since slice 13 they hold the
   epilogue's redesigned bf16 body (``wgmma``, W and the residual by TMA)
   the same way.  Per-call times at batch 384 bf16 of each kernel and its shipped form
   (in turns), its plain version and the PyTorch yardstick (once each:
   SDPA, one call for cat and headfold, two for dual; SDPA + ``addmm`` +
   ``layer_norm`` for the epilogue, a composition), beside its bound;
   dual and cat and their pairs also at batch 32.  Runs ``python -m
   rgqa_tpu_torch.experiments.{xfuse_exp,headfold_exp,epilogue_exp}
   --iters 5`` (each must exit 0 and launch each of its kernels), then
   holds the kernels the other experiments launch (6a, 6b) at their
   shapes: #1 at 56x56 and #2 at 165x165 (batch 384), #3 at 36x36 and
   20x36 (batch 384), #3L at 165x165 (batch 128), with times and bounds.
14. scorers (slice 10): full-width LxmertForGQA in bf16 from a seeded
   generator, batch 256 with padded text, each scorer through the kernels
   and through the plain versions (``use_fused=False``) on the same
   batches: msp, energy, ODIN (``ODIN_T`` 1000, step ``ODIN_NOISE``
   1e-2), Mahalanobis un-noised and noised (``MAHA_NOISE``) and
   MC-dropout (``SEED_LIST``, dropout 0.1).  Launches per batch of 256:
   34 of #1 for msp, energy and un-noised Mahalanobis; for ODIN and
   noised Mahalanobis 68 of #1 (the gradient pass and the rescore) and 23
   of #3 (the input gradient runs the backward of the attentions on a
   path from the RoI inputs to the pooled output only: 5 vision layers,
   4 per cross layer but the last, whose vision pair feeds nothing
   pooled, and its 2 language calls); for MC-dropout 34 of #4 per pass
   (170) and none of #1; no other kernel.  Labels agree on
   ``MIN_LABEL_AGREEMENT`` and scores within ``SCORE_TOL`` (see there;
   for ODIN and noised Mahalanobis on the rows whose gradient passes made
   the same decision: elsewhere the two paths perturb toward different
   losses).
   ODIN's and noised Mahalanobis' input gradients (``g_feats``,
   ``g_boxes``) through the kernels are held to the plain path's:
   relative L2 error within ``GRAD_RTOL`` (see there) and the same sign wherever
   |g| is above round-off (``GRAD_SIGN_FLOOR``), on the rows where both
   gradient passes made the same decision (at least
   ``MIN_LABEL_AGREEMENT`` of them).  The pooled features the
   Mahalanobis scorers score agree within ``POOLED_TOL`` (phase 4's
   bound), and the noised scores differ from the un-noised ones.  The
   estimator is fitted (``FIT_BATCHES`` batches of 256, ``FIT_CLASSES``
   classes that the pooled features separate: see ``_fit_batches``)
   through the kernels in eval mode, timed per batch, its precision's
   eigenvalue range printed; no scorer leaves the model in
   training mode.  ms per batch and questions/s of each, kernels and
   plain in turns.  The phase reports every failed check at its end.
15. scorer CLI (slice 10): ``python -m rgqa_tpu_torch.cli.evaluate
   --synthetic --test testdev --batchSize 256`` at full width with
   ``--scorer energy``, ``odin``, ``dropout``, ``maha`` (on a root of
   ``MAHA_ROOT``'s 8192 labeled train questions; the first run fits and
   writes ``sample_estimates.pkl``, the second reads it),
   ``--target_acc`` (at half the accuracy the favoured answer reaches)
   and ``--load a.pth,b.pth`` (an ensemble), from seeded weights written
   as reference ``.pth`` files (``a.pth``'s answer bias favours testdev's
   most frequent answer, so some answers are right); then ViLT with
   ``--scorer dropout`` and ``energy`` through #2.  Each run's launches
   equal the counts of phase 14 per scored batch (plus 34 of #1 per
   train batch of the fit), its prediction JSON holds one row per
   question with a known answer and a finite confidence, and its metric
   dict (or tau) is finite.  As phase 5, each run is then re-scored with
   its own runner, weights and options through the plain versions: the
   answers agree on ``MIN_LABEL_AGREEMENT`` of the questions and the
   confidences within the scorer's ``SCORE_TOL`` plus the 1e-4 step of
   the prediction JSON's 4 dp (``--target_acc``, whose dump is at full
   precision: against the plain re-score under its own tau).  The
   Mahalanobis runs hold their answers, not their scores (see
   ``phase_scorer_cli``); the cached run's JSON equals the first run's.
16. prepare (slice 12): writes a TSV from the synthetic root's feature
   pack (every image at 36 boxes, one at 50, whose extra boxes the
   packer truncates, and one extra image at 10, which it zero-pads) and
   packs it (``data.tsv.pack_obj_tsv``): the synthetic images' rows equal
   the synthetic pack's, the short row is zero-padded.  Then ``python -m
   rgqa_tpu_torch.cli.prepare_data`` writes a fresh data root from the
   TSV and the synthetic root's JSONs and vocabulary, whose feature pack
   equals the first pack file for file.
17. serve (slice 12): ``rgqa_tpu_torch.cli.serve.main`` on one JSONL
   stream (``SERVE_RECORDS`` good records, a malformed line, a line that
   is not an object, a record without fields, an unknown ``img_id`` and
   two records that share a question id) at full width, batch 256, bf16:
   LXMERT ``--scorer msp`` on the prepared root, one output line per
   record (the four error records among them), the two records of the
   shared id each answered, 34 launches of #1 per forward and no other
   kernel, the ``--serve_stats`` count equal to the records scored, the
   same lines as a serve on the synthetic root the TSV came from, labels
   and confidences held to a plain-attention re-score of the same rows
   (``MIN_LABEL_AGREEMENT``, ``CONF_TOL`` plus the 4 dp step); ``--scorer
   maha`` (bf16 compute), whose fit reads f32 weights (checked on the
   runner the fit runs on) and whose launches are 34 of #1 per fit batch
   and per forward; ``--backbone vilt`` msp, 12 launches of #2 per
   forward and none else; and a latency tier at ``--batchSize 8``,
   ``LATENCY_RECORDS`` records arriving one every ``LATENCY_INTERVAL`` s,
   whose p50 / p95 / p99 it prints.
18. the kernels' JSON line (times: the sum over the LXMERT shapes, and
   for #2 and #3L over 165x165 and 185x185, bf16, batch 256; for the
   four experiment kernels the sum over their shapes and variants at
   batch 384), the nvidia-smi line, and last ``{"ok": true, "device":
   {...}}``.

Needs the repository beside it; it imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import typing

E, HEADS = 768, 12
SHAPES = ((20, 20), (36, 36), (20, 36), (36, 20))  # (Sq, Skv) per LXMERT call kind
VILT_SHAPES = ((165, 165), (185, 185))  # ViLT's stream: 20 or 40 text tokens + 144 patches + CLS
LONG_SHAPES = VILT_SHAPES + ((65, 185), (185, 65))
# Either side of 256 keys, where #2's f32 body leaves its whole-row form
# for its key-tiled one (the old cap of both long kernels).
LIMIT_SHAPES = ((20, 256), (256, 256), (20, 257), (257, 257))
# ViLT beyond 256 tokens: a 512 px image (16^2 + 1 + 20 = 277 tokens) and
# 16 px patches at 384 px (24^2 + 1 + 20 = 597), with ragged pairs.
BEYOND_SHAPES = ((277, 277), (597, 597), (20, 597), (597, 20))
# The batch a long shape runs at beside batch 7: at 597 tokens the plain
# backward's (64, 12, 597, 597) f32 intermediates are ~1.1 GB each.
def long_batch(sq: int, skv: int) -> int:
    return 64 if max(sq, skv) > 300 else 256


# #2 and #3L are timed (bf16, beside SDPA and the bound) at these shapes.
LONG_TIMED = VILT_SHAPES + ((277, 277), (597, 597))
VILT_LONG_FLAGS = (("--vilt_image_size", "512"), ("--vilt_patch_size", "16"))  # 277 / 597 tokens
# (atol, rtol) per kernel and dtype; see the docstring.
TOL = {
    ("fused_attention", "float32"): (2e-5, 0.0),
    ("fused_attention_long", "float32"): (2e-5, 0.0),
    ("dual_pair", "float32"): (2e-5, 0.0),
    ("cat_call", "float32"): (2e-5, 0.0),
    ("headfold", "float32"): (2e-5, 0.0),
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
    # The experiment entry points' kernels (rgqa_tpu_torch/experiments).
    "dual_pair": ("rgqa_tpu_torch/csrc/xfuse.cu", "experiments/xfuse_exp.py:83"),
    "cat_call": ("rgqa_tpu_torch/csrc/xfuse.cu", "experiments/xfuse_exp.py:128"),
    # One kernel for both head-fold bodies, _concat_kernel and _scratch_kernel.
    "headfold": ("rgqa_tpu_torch/csrc/headfold.cu", "experiments/headfold_exp.py:62,98"),
    "epi_fused": ("rgqa_tpu_torch/csrc/epilogue.cu", "experiments/epilogue_exp.py:30"),
}
EXPERIMENTS = ("xfuse_exp", "headfold_exp", "epilogue_exp")  # rgqa_tpu_torch.experiments.*
# Phase 14, the scorers: batches of 256 scored; the Mahalanobis fit's
# batches and classes (4 classes of ~1024 rows: the sampling noise of the
# class means, which the precision amplifies into the class gaps, falls
# as 1 / sqrt(rows per class); with 16 classes of ~256 rows the two paths'
# labels agreed on 0.897 of the rows); MC-dropout's seeds; ODIN's temperature
# and step, and the noised Mahalanobis step (1e-2: at bf16's resolution
# of the RoI feats, which the model casts to bf16 in its first product;
# a smaller step rounds away there, and at T 1e5 every ODIN score is 0.5
# to f32's resolution); timed calls per scorer.
SCORE_BATCHES = 2
FIT_BATCHES = 16
FIT_CLASSES = 4
SEED_LIST = (0, 1, 2, 3, 4)
ODIN_T, ODIN_NOISE = 1000.0, 1e-2
MAHA_NOISE = 1e-2
SCORER_ITERS = {"msp": 20, "energy": 20, "maha": 20, "odin": 10, "dropout": 5}
# (atol, rtol) of a scorer's scores, kernels against plain versions, the
# same bf16 weights.  msp, MC-dropout (the same masks: #4's keyed mask is
# the plain version's, and the hidden-dropout bytes come from the same
# seeded generators) and the ensemble (the mean of two MSP vectors): the
# MSP confidence bound.  Energy: softplus has slope <= 1 and the top-2
# logits move by at most LOGIT_TOL each.  ODIN: sigmoid(l / T) has slope
# <= 1 / (4 T); the rescore's logits differ by up to LOGIT_TOL through
# the attention and by up to LOGIT_TOL more through the inputs whose
# gradient sign flipped at round-off.  Mahalanobis: relative (scores
# ~-840..-200): the precision's small eigenvalues (see GRAD_RTOL) amplify
# the pooled features' bf16 difference (up to 4.5% of a score measured
# on the H100).  Noised, twice that: the two paths' inputs also differ
# where the gradient's sign flipped at round-off (~4% of the elements,
# each by 2 x MAHA_NOISE), and the step toward the top class shrinks
# |score| but not the round-off term (up to 5.4% measured).
SCORE_TOL = {
    "msp": (CONF_TOL, 0.0), "dropout": (CONF_TOL, 0.0), "ensemble": (CONF_TOL, 0.0),
    "energy": (2 * LOGIT_TOL, 0.0), "odin": (LOGIT_TOL / (2 * ODIN_T), 0.0),
    "maha": (0.0, 5e-2), "maha_noised": (0.0, 1e-1),
}
# The pooled features a Mahalanobis scorer scores, kernels against plain
# versions: phase 4's bf16 bound.
POOLED_TOL = LOGIT_TOL
# The input gradient of ODIN and noised Mahalanobis (g_feats, g_boxes),
# kernels against plain versions, at batch 256 in bf16: relative L2 error
# at most GRAD_RTOL, and the same sign01 wherever |g_plain| exceeds
# GRAD_SIGN_FLOOR of its largest magnitude (below that the sign is
# round-off: both paths compute the backward in bf16, the kernels round
# dS to bf16 where the plain version keeps f32).  A zero gradient has
# relative error 1, one of the wrong sign 2.  ODIN's loss reads the
# logits; the Mahalanobis loss's gradient at the pooled output is
# P (f - mu), so the precision's small eigenvalues (within-class variances
# to ~6e-5: a random model's pooled features collapse onto few
# directions, at any number of fit rows) amplify the pooled features'
# bf16 difference into it (1.3e-1 measured on the H100, ODIN's 2e-2).
GRAD_RTOL = {"odin": 0.1, "maha": 0.25}
GRAD_SIGN_FLOOR = 0.1
# Phase 15's root for the Mahalanobis runs: 8192 labeled train questions
# on 256 images (the default root's 256 rows leave the covariance of 768
# dimensions singular).
MAHA_ROOT = dict(n_images=256, n_train=8192)
VILT_TRAIN_TEXT = 20  # the train CLI's --max_text_len: a 165-token stream
# Phases 16-17, prepare and serve: good records of the serve stream (two
# forwards at batch 256), the extra boxes of the TSV's long row and the
# boxes of its short one, and the latency tier's arrivals.
SERVE_RECORDS = 300
LONG_ROW_BOXES, SHORT_ROW_BOXES = 50, 10
LATENCY_RECORDS, LATENCY_INTERVAL = 20, 0.1


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
    import importlib

    modules = [importlib.import_module(m) for m in (
        "rgqa_tpu_torch.ops.attention", *(f"rgqa_tpu_torch.experiments.{e}" for e in EXPERIMENTS))]
    return {name: next(getattr(m, f"{name}_cuda") for m in modules if hasattr(m, f"{name}_cuda"))
            for name in KERNELS}


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
            if any(w in line for w in ("entry function", "registers", "spill", "rror", "Performance Loss")):
                log("build", "  " + line.strip())
    _wgmma_report(results["headfold"])
    _long_wgmma_report(results["fused_attention_long"])
    _epilogue_report(results["epilogue"])


WGMMA_KERNEL = re.compile(r"headfold_wgmmaILi(\d+)E")  # headfold_wgmma<kNP>, kNP keys in the window
LONG_WGMMA_KERNEL = re.compile(r"fused_attention_long_wgmmaILi(\d+)E")  # <kWG> warpgroups a block
EPI_KERNEL = re.compile(r"epilogue_bf16ILi(\d+)E")  # epilogue_bf16<kNP>, kNP keys in a window


def _ptxas_resources(text: str) -> dict:
    """Per entry function of a ``-Xptxas -v`` log: registers, spill stores
    and loads (bytes) and static shared memory (bytes)."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {"registers": None, "spill_stores": 0, "spill_loads": 0, "smem": 0})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn]["spill_stores"], out[fn]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[fn]["smem"] = int(sm.group(1)) if sm else 0
    return out


def _sass_hgmma(path) -> dict | None:
    """``cuobjdump -sass``'s count of HGMMA instructions per function of a
    built library; None where the toolkit has no cuobjdump."""
    from rgqa_tpu_torch.ops._build import cuda_tool

    tool = cuda_tool("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def _wgmma_report(res) -> None:
    """The bf16 head-fold body's instances (one per window size): registers,
    spills and shared memory from the build log, and HGMMA in their SASS."""
    from rgqa_tpu_torch.experiments import headfold_exp

    if not res.log:
        log("build", "headfold bf16 body: reused build, no ptxas log to read")
        return
    used = sorted({headfold_exp.fold_plan(sq, skv, f).n for sq, skv in headfold_exp.SHAPES
                   for _, f in headfold_exp.CANDIDATES})
    res_by_n = {int(m.group(1)): r for fn, r in _ptxas_resources(res.log).items()
                if (m := WGMMA_KERNEL.search(fn))}
    sass = _sass_hgmma(res.path)
    hgmma = None if sass is None else {int(m.group(1)): c for fn, c in sass.items()
                                       if (m := WGMMA_KERNEL.search(fn))}
    parts = []
    for n in sorted(res_by_n):
        r = res_by_n[n]
        part = (f"N={n}{' (used at the experiment shapes)' if n in used else ''}: {r['registers']} registers, "
                f"spill {r['spill_stores']}/{r['spill_loads']} B stores/loads, smem {r['smem']} B static + "
                f"{headfold_exp.window_smem_bytes(n)} B dynamic")
        if hgmma is not None:
            part += f", {hgmma.get(n, 0)} HGMMA in SASS"
        parts.append(part)
    log("build", "headfold bf16 body (headfold_wgmma<N>, wgmma): " + "; ".join(parts)
        + ("" if hgmma is not None else "; cuobjdump not in the toolkit: SASS not read"))
    if hgmma is not None and not all(hgmma.get(n, 0) > 0 for n in used):
        raise AssertionError(f"headfold's bf16 body issues no HGMMA at some used N: {hgmma}")


def _long_ring_smem(wg: int) -> int:
    """Dynamic shared memory of #2's bf16 body with ``wg`` warpgroups a
    block, as ``ring_smem_bytes`` in ``csrc/fused_attention_long.cu``
    lays it out: ``wg`` Q tiles and 3 ring stages each of K and V (64 x
    64 bf16 a tile), 3 stages of 64 f32 bias, and one 1024-byte swizzle
    period for the alignment."""
    tile, stages = 64 * 64 * 2, 3
    return tile * (wg + 2 * stages) + 4 * 64 * stages + 1024


def _long_wgmma_report(res) -> None:
    """#2's bf16 body (``fused_attention_long_wgmma<kWG>``, one instance
    per warpgroups a block): registers, spills and static shared memory
    from the build log, the dynamic shared memory of its layout, and
    HGMMA in its SASS; an instance without HGMMA fails the phase."""
    res_by_wg = {int(m.group(1)): r for fn, r in _ptxas_resources(res.log).items()
                 if (m := LONG_WGMMA_KERNEL.search(fn))}
    sass = _sass_hgmma(res.path)
    hgmma = None if sass is None else {int(m.group(1)): c for fn, c in sass.items()
                                       if (m := LONG_WGMMA_KERNEL.search(fn))}
    parts = []
    for wg in sorted(set(res_by_wg) | set(hgmma or {})):
        part = f"{wg} warpgroups: {_long_ring_smem(wg)} B dynamic smem"
        if wg in res_by_wg:
            r = res_by_wg[wg]
            part += (f", {r['registers']} registers, spill {r['spill_stores']}/{r['spill_loads']} B "
                     f"stores/loads, {r['smem']} B static smem")
        if hgmma is not None:
            part += f", {hgmma.get(wg, 0)} HGMMA in SASS"
        parts.append(part)
    log("build", "#2 bf16 body (fused_attention_long_wgmma<kWG>, wgmma): " + "; ".join(parts)
        + ("" if res.log else "; reused build, no ptxas log to read")
        + ("" if hgmma is not None else "; cuobjdump not in the toolkit: SASS not read"))
    if hgmma is not None and (not hgmma or not all(hgmma.values())):
        raise AssertionError(f"#2's bf16 body has no HGMMA in some instance: {hgmma}")


def _epilogue_report(res) -> None:
    """The epilogue's bf16 body (``epilogue_bf16<kNP>``, kNP keys in a
    window): registers, spills and static shared memory from the build log,
    its dynamic shared memory (``epilogue_exp.epi_smem_bytes``), and HGMMA
    in its SASS; an instance without HGMMA, or one that spills, fails the
    phase."""
    from rgqa_tpu_torch.experiments import epilogue_exp

    used = sorted({epilogue_exp.epi_plan(b, sq, skv).keys for b in (384, 7) for sq, skv in EPI_SHAPES})
    res_by = {int(m.group(1)): r for fn, r in _ptxas_resources(res.log).items() if (m := EPI_KERNEL.search(fn))}
    sass = _sass_hgmma(res.path)
    hgmma = None if sass is None else {int(m.group(1)): c for fn, c in sass.items() if (m := EPI_KERNEL.search(fn))}
    parts = []
    for n in sorted(set(res_by) | set(hgmma or {})):
        part = (f"N={n}{' (used at the smoke shapes)' if n in used else ''}: "
                f"{epilogue_exp.epi_smem_bytes(n)} B dynamic smem")
        if n in res_by:
            r = res_by[n]
            part += (f", {r['registers']} registers, spill {r['spill_stores']}/{r['spill_loads']} B "
                     f"stores/loads, {r['smem']} B static smem")
        if hgmma is not None:
            part += f", {hgmma.get(n, 0)} HGMMA in SASS"
        parts.append(part)
    log("build", "epilogue bf16 body (epilogue_bf16<N>, wgmma + TMA): " + "; ".join(parts)
        + ("" if res.log else "; reused build, no ptxas log to read")
        + ("" if hgmma is not None else "; cuobjdump not in the toolkit: SASS not read"))
    if hgmma is not None and (not hgmma or not all(hgmma.values())):
        raise AssertionError(f"the epilogue's bf16 body has no HGMMA in some instance: {hgmma}")
    spilled = {n: r for n, r in res_by.items() if r["spill_stores"] or r["spill_loads"]}
    if spilled:
        raise AssertionError(f"the epilogue's bf16 body spills registers: {spilled}")


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
    return _bound(nbytes, flops)


def _bound(nbytes: int, flops: int) -> tuple[float, str]:
    """The larger of moving ``nbytes`` at the memory rate and doing
    ``flops`` at the bf16 tensor-core rate, in ms, and which it is."""
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
        for b in (256, 64, 7):
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
                if (sq, skv) == (36, 36):
                    # No float atomics: two runs give identical bits.
                    for name, (kernel, _) in calls.items():
                        first, again = kernel(), kernel()
                        if isinstance(first, torch.Tensor):
                            first, again = (first,), (again,)
                        if not all(torch.equal(x, y) for x, y in zip(first, again)):
                            raise AssertionError(f"{name} reruns differ at {dname} B={b} {sq}x{skv}")
                    msg += "; #1/#3/#4/#5 reruns bit-identical"
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
                if b == 256 or (b == 64 and dtype == torch.bfloat16):
                    # Batch 256 times every kernel (the JSON line's times);
                    # batch 64, a training step's rows, every kernel in bf16.
                    timed = calls
                    key = (dname, sq, skv) if b == 256 else (dname, sq, skv, b)
                    lib = _sdpa_calls(q, k, v, g, bias)
                    library = {
                        "fused_attention": lambda: cuda_ms(lib["fwd"]),
                        "fused_attention_bwd": lambda: cuda_ms(lib["fwd_bwd"]) - cuda_ms(lib["fwd"]),
                        "fused_attention_dropout": lambda: cuda_ms(lib["drop"]),
                        "fused_attention_dropout_bwd":
                            lambda: cuda_ms(lib["drop_fwd_bwd"]) - cuda_ms(lib["drop"]),
                    }
                    for name in timed:
                        kernel, plain = calls[name]
                        plain_ms, kernel_ms = in_turns(plain, kernel)
                        bound, _ = _bound_ms(name, b, sq, skv, q.element_size())
                        times[(name, *key)] = (kernel_ms, plain_ms, library[name](), bound)
                    msg += "; us kernel/plain/library/bound: " + ", ".join(
                        f"{n.replace('fused_attention', '#')} " + "/".join(
                            f"{x * 1e3:.1f}" for x in times[(n, *key)])
                        for n in timed
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
    """#2 and #3L against their plain versions at ViLT's shapes, either side
    of 256 keys and beyond (277 and 597 tokens); #2 with its row
    statistics gives the same output bits, and in f32 their log-sum-exp is
    the plain scores'; #3L's two runs bit for bit; times at LONG_TIMED
    (#3L in bf16)."""
    import torch

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for sq, skv in LONG_SHAPES + LIMIT_SHAPES + BEYOND_SHAPES:
            for b in (long_batch(sq, skv), 7):
                q, k, v, g, _ = _attention_inputs(b, sq, skv, dtype, gen)
                bias = _pad_patch_bias(b, skv, gen)
                out, lse = att.fused_attention_long_cuda(q, k, v, bias, HEADS, lse=True)
                calls = {
                    "fused_attention_long": (
                        lambda: att.fused_attention_long_cuda(q, k, v, bias, HEADS),
                        lambda: att.attention_natural_ref(q, k, v, bias, HEADS)),
                    "fused_attention_long_bwd": (
                        lambda: att.fused_attention_long_bwd_cuda(q, k, v, bias, g, HEADS, lse),
                        lambda: att.attention_bwd_ref(q, k, v, bias, g, HEADS)),
                }
                msgs = []
                for name, (kernel, plain) in calls.items():
                    got, want = kernel(), plain()
                    torch.cuda.synchronize()
                    msgs.append(_compare(name, dtype, got, want, errs))
                    if name == "fused_attention_long" and not torch.equal(got, out):
                        raise AssertionError(f"#2 with row statistics differs at {dname} B={b} {sq}x{skv}")
                if not all(torch.equal(a, c) for a, c in zip(got, calls["fused_attention_long_bwd"][0]())):
                    raise AssertionError(f"two runs of #3L differ at {dname} B={b} {sq}x{skv}")
                msg = (f"{dname} B={b} {sq}x{skv}: max|kernel-plain| " + "; ".join(msgs)
                       + "; #2 with statistics: equal bits; #3L twice: equal bits")
                if dtype == torch.float32:
                    msg += "; " + _lse_check(q, k, bias, lse)
                if b > 7 and (sq, skv) in LONG_TIMED:
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
                del q, k, v, g, bias, got, want, calls, out, lse
                torch.cuda.empty_cache()


def _lse_check(q, k, bias, lse) -> str:
    """#2's row statistics (m, log(sum)): their sum against torch.logsumexp
    of the f32 scores as the plain version takes them, in f64, within 1e-5
    + 1e-7 |lse| (the fully masked row's scores lie near -1e4, on the f32
    grid of 2^-10, where a product summed in another order moves a score
    by a step)."""
    import torch

    b, sq, _ = q.shape
    qh, kh = (t.reshape(b, -1, HEADS, E // HEADS) for t in (q, k))
    scores = (torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(E // HEADS)).float()
    want = torch.logsumexp((scores + bias[:, None, None, :]).double(), dim=-1)
    diff = (lse.double().sum(-1) - want).abs()
    err = diff.max().item()
    if not bool((diff <= 1e-5 + 1e-7 * want.abs()).all()):
        raise AssertionError(f"#2's log-sum-exp is {err:.3e} from the plain scores' "
                             "(bound 1e-5 + 1e-7 |lse|)")
    return f"max|lse - logsumexp| {err:.1e}"


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
        cfg, device, _ = evaluate.parse_args(argv[:-1] + [os.path.join(tmp, "plain")])
        forwards = math.ceil(len(ds) / cfg.train.batch_size)
        if launches[kernel] != per_forward * forwards:
            raise AssertionError(
                f"{launches[kernel]} launches of {kernel}, want {per_forward} per forward x "
                f"{forwards} forwards ({len(ds)} questions, batch {cfg.train.batch_size})")

        # Reference on the same split: the same runner and weights, with
        # every attention call through the plain version.
        runner = GQARunner(cfg, init_train=False, device=device)
        plain_forward = lambda batch, **kw: runner.forward(batch, use_fused=False, **kw)  # noqa: E731
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


def _train_model(dropout: float, backbone: str, patch: int | None = None):
    import torch
    from rgqa_tpu_torch.models.zoo import build_model, default_config

    cfg = default_config(backbone)
    if backbone == "vilt":
        cfg = dataclasses.replace(cfg, max_text_len=VILT_TRAIN_TEXT)
    if patch is not None:
        cfg = dataclasses.replace(cfg, vilt_patch_size=patch)
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


def phase_train_steps(backbone: str = "lxmert", patch: int | None = None,
                      dropouts=(0.0, RATE), n: int = 4, timed: int = 10, phase: str | None = None):
    """``n`` steps from one init through the kernels and through the plain
    versions at each dropout rate; ``timed`` more steps of each, in turns.
    ``patch``: ViLT's patch size (16: the 597-token stream)."""
    import torch

    phase = phase or ("train" if backbone == "lxmert" else f"{backbone}-train")
    rows = 64  # batch 32 plus its 32 RP pairs
    result = {}
    for dropout in dropouts:
        cfg, model, forward = _train_model(dropout, backbone, patch)
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
        log(phase, f"dropout {dropout}: batch 32 + RP ({rows} rows), {n} steps from one init: "
            f"launches per step {per_step}; losses kernels {[round(x, 4) for x in k_losses]}, "
            f"plain {[round(x, 4) for x in p_losses]}, max relative gap {max(rel):.3e}"
            + (f" (bound {LOSS_RTOL:.0e})" if dropout == 0.0 else " (same masks: the same seeds and bytes)"))
        log(phase, f"dropout {dropout}: ms per step (mean of {timed} after {n} warm-up, in turns) "
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


def phase_vilt_train_path(extra=(), phase: str = "vilt-train"):
    """The ViLT train CLI at full width from the synthetic pixel pack
    (``extra`` flags added, to the evaluate too), its launches,
    checkpoints and an evaluate of its ``BEST.pth``."""
    import torch
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.cli import train as train_cli
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.data.dataset import GQADataset

    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_vilt_train_") as tmp:
        root, out_dir = os.path.join(tmp, "gqa"), os.path.join(tmp, "snap")
        argv = ["--backbone", "vilt", *extra, "--synthetic", "--data_root", root, "--sample_pair",
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
        eargv = ["--backbone", "vilt", *extra, "--synthetic", "--data_root", root, "--test",
                 "testdev", "--load", os.path.join(out_dir, "BEST.pth"), "--output", eval_dir]
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


# ---------------------------------------------------------------------------
# Phase 12: ViLT beyond 256 tokens (slice 6).
# ---------------------------------------------------------------------------


def phase_vilt_long():
    """The evaluate CLI at a 512 px image (277 tokens) through #2 alone, the
    train CLI with 16 px patches (597 tokens) through #2 and #3L, and two
    dropout-0 steps at 597 tokens through the kernels and the plain
    versions; full width, each path's launch counts zeroed before it and
    read after."""
    image, patch = VILT_LONG_FLAGS
    phase_main_path("vilt-277", ("--backbone", "vilt", *image), "fused_attention_long", 12)
    phase_vilt_train_path(patch, phase="vilt-597")
    phase_train_steps("vilt", patch=16, dropouts=(0.0,), n=2, timed=4, phase="vilt-597")


# ---------------------------------------------------------------------------
# Phase 13: the experiments (slice 5).
# ---------------------------------------------------------------------------

EXP_ITERS = 20  # launches per timing in phase 13 (34 cases; the kernel and the shipped form in turns)
# The epilogue's shapes: LXMERT's four and a short query (7 rows) whose
# block spans ten batch rows, in five key windows a head.
EPI_SHAPES = ((20, 20), (36, 36), (20, 36), (36, 20), (7, 36))


def _exp_stream(b, s, dtype, gen):
    """q, k, v (B, S, E) and a (B, S) -10000 mask: up to a quarter of each
    row's keys padded at the end, row B/2 fully masked."""
    import torch

    q, k, v = (torch.randn(b, s, E, generator=gen, device="cuda").to(dtype) for _ in range(3))
    pad = torch.randint(0, s // 4 + 1, (b, 1), generator=gen, device="cuda")
    visible = torch.arange(s, device="cuda")[None, :] < s - pad
    visible[b // 2] = False
    return q, k, v, (~visible).float() * -10000.0


def _sdpa(q, k, v, mask):
    """One ``scaled_dot_product_attention`` call on (B, H, S, D) views;
    ``mask`` (B, Skv) or (B, 1, Sq, Skv) additive."""
    import torch.nn.functional as F

    def heads(t):
        return t.view(t.shape[0], t.shape[1], HEADS, E // HEADS).transpose(1, 2)

    m = (mask[:, None, None, :] if mask.dim() == 2 else mask).to(q.dtype)
    return F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=m)


class _Case(typing.NamedTuple):
    """One call of an experiment kernel: the kernel, its plain version, the
    shipped form it replaces (its output rearranged as the kernel's), the
    PyTorch yardstick, and the bytes and products of the call."""

    name: str
    label: str
    kernel: object
    plain: object
    shipped: object
    library: object
    nbytes: int
    flops: int
    exact: bool = False  # the kernel equals the shipped form bit for bit


def _exp_cases(b, dtype, gen):
    """Every call of the four kernels at the experiments' shapes."""
    import torch
    from rgqa_tpu_torch.experiments import epilogue_exp, headfold_exp, xfuse_exp
    from rgqa_tpu_torch.ops import attention as att

    d, it = E // HEADS, torch.finfo(dtype).bits // 8
    lang, vis = _exp_stream(b, 20, dtype, gen), _exp_stream(b, 36, dtype, gen)

    def one(q, k, v, m):
        return att.fused_attention_cuda(q, k, v, m, HEADS)

    def attn_bytes(sq, skv):
        return b * (2 * sq + 2 * skv) * E * it + b * skv * 4

    cases = []
    for label, mode in (("cross", "xor"), ("self", "diag")):
        pa, pb = xfuse_exp.pair_problems(mode, lang, vis)
        sa, ska, sb, skb = pa[0].shape[1], pa[1].shape[1], pb[0].shape[1], pb[1].shape[1]
        flops = 4 * b * HEADS * (sa * ska + sb * skb) * d
        cases.append(_Case(
            "dual_pair", label, lambda pa=pa, pb=pb: xfuse_exp.dual_pair_cuda(*pa, *pb),
            lambda pa=pa, pb=pb: xfuse_exp.dual_pair_ref(*pa, *pb),
            lambda pa=pa, pb=pb: (one(*pa), one(*pb)),
            lambda pa=pa, pb=pb: (_sdpa(*pa), _sdpa(*pb)),
            attn_bytes(sa, ska) + attn_bytes(sb, skb), flops, exact=True))
        cat = [torch.cat(p, 1) for p in zip(lang, vis)]  # [language; vision]
        struct = xfuse_exp.cat_struct(56, 20, mode, "cuda")
        cases.append(_Case(
            "cat_call", f"{mode} ({label} pair)",
            lambda cat=cat, mode=mode: xfuse_exp.cat_call_cuda(*cat, 20, mode),
            lambda cat=cat, mode=mode: xfuse_exp.cat_call_ref(*cat, 20, mode),
            lambda pa=pa, pb=pb: torch.cat([one(*pa), one(*pb)], 1),
            lambda cat=cat, struct=struct: _sdpa(*cat[:3], cat[3][:, None, None, :] + struct),
            attn_bytes(56, 56), 4 * b * HEADS * 56 * 56 * d))
    for sq, skv in headfold_exp.SHAPES:
        q, k, v, m = _exp_stream(b, max(sq, skv), dtype, gen)
        q, k, v, m = q[:, :sq].contiguous(), k[:, :skv].contiguous(), v[:, :skv].contiguous(), m[:, :skv].contiguous()
        for variant, fold in headfold_exp.CANDIDATES:
            args = (q, k, v, m, fold, variant)
            cases.append(_Case(
                "headfold", f"{sq}x{skv} {variant} F={fold}",
                lambda args=args: headfold_exp.headfold_cuda(*args),
                lambda args=args: headfold_exp.headfold_ref(*args),
                lambda args=args: one(*args[:4]), lambda args=args: _sdpa(*args[:4]),
                attn_bytes(sq, skv), fold * 4 * b * HEADS * sq * skv * d))
    for sq, skv in EPI_SHAPES:
        q, k, v, m = _exp_stream(b, max(sq, skv), dtype, gen)
        q, k, v, m = q[:, :sq].contiguous(), k[:, :skv].contiguous(), v[:, :skv].contiguous(), m[:, :skv].contiguous()
        res = torch.randn(b, sq, E, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(E, E, generator=gen, device="cuda") * 0.02).to(dtype)
        wb, be = (torch.randn(E, generator=gen, device="cuda") * 0.02 for _ in range(2))
        g = 1.0 + torch.randn(E, generator=gen, device="cuda") * 0.02
        args = (q, k, v, m, res, w, wb, g, be)
        ln = epilogue_exp.layer_norm(g, be)

        def library(args=args):
            q, k, v, m, res, w, wb, g, be = args
            ctx = _sdpa(q, k, v, m).transpose(1, 2).reshape(-1, E)
            y = torch.addmm(wb.to(q.dtype), ctx, w).view(q.shape) + res
            return torch.nn.functional.layer_norm(y.float(), (E,), g, be, epilogue_exp.EPS).to(q.dtype)

        cases.append(_Case(
            "epi_fused", f"{sq}x{skv}", lambda args=args: epilogue_exp.epi_fused_cuda(*args),
            lambda args=args: epilogue_exp.epi_fused_ref(*args),
            lambda args=args, ln=ln: epilogue_exp.split(*args[:7], ln), library,
            attn_bytes(sq, skv) + b * sq * E * it + E * E * it + 3 * E * 4,
            4 * b * HEADS * sq * skv * d + 2 * b * sq * E * E))
    return cases


def _run_experiments() -> dict:
    """The three entry points, each in its own process: exit 0 and every
    kernel of its module launched; their launch counts."""
    launches = {}
    for exp in EXPERIMENTS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"rgqa_tpu_torch.experiments.{exp}", "--iters", "5"],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            raise AssertionError(f"{exp} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        counts = json.loads(lines[-1].removeprefix("launches "))
        log("experiments", f"python -m rgqa_tpu_torch.experiments.{exp} --iters 5: exit 0 in "
            f"{time.perf_counter() - t0:.2f} s, launches {counts}")
        for line in lines[:-1]:
            log("experiments", f"  {line}")
        if not counts or not all(n > 0 for n in counts.values()):
            raise AssertionError(f"{exp} did not launch each of its kernels: {counts}")
        launches.update(counts)
    return launches


def _held_shapes(att, gen, errs):
    """6a / 6b: the kernels the other experiment entry points launch, at
    their shapes, against their plain versions; bf16 timed beside SDPA."""
    import torch

    for name, b, sq, skv in (("fused_attention", 384, 56, 56), ("fused_attention_long", 384, 165, 165),
                             ("fused_attention_bwd", 384, 36, 36), ("fused_attention_bwd", 384, 20, 36),
                             ("fused_attention_long_bwd", 128, 165, 165)):
        msgs = []
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g, _ = _attention_inputs(b, sq, skv, dtype, gen)
            bias = _pad_patch_bias(b, skv, gen)
            kernel = getattr(att, f"{name}_cuda")
            args = (q, k, v, bias, g, HEADS) if name.endswith("bwd") else (q, k, v, bias, HEADS)
            if name == "fused_attention_long_bwd":
                kernel = functools.partial(
                    kernel, lse=att.fused_attention_long_cuda(q, k, v, bias, HEADS, lse=True)[1])
            plain = att.attention_bwd_ref if name.endswith("bwd") else att.attention_natural_ref
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            msgs.append(_compare(name, dtype, got, want, {}))
            if dtype == torch.bfloat16:
                plain_ms, kernel_ms = in_turns(lambda: plain(*args), lambda: kernel(*args), iters=EXP_ITERS)
                bound, _ = _bound_ms(name, b, sq, skv, 2)
                lib = _sdpa_calls(q, k, v, g, bias)
                library = cuda_ms(lib["fwd"], iters=EXP_ITERS)
                if name.endswith("bwd"):
                    library = cuda_ms(lib["fwd_bwd"], iters=EXP_ITERS) - library
                msgs.append(f"bf16 us kernel/plain/library/bound {kernel_ms * 1e3:.1f}/{plain_ms * 1e3:.1f}/"
                            f"{library * 1e3:.1f}/{bound * 1e3:.1f}")
            del q, k, v, g, bias, got, want
            torch.cuda.empty_cache()
        log("experiments", f"6a/6b: {name} B={b} {sq}x{skv}: " + "; ".join(msgs))


def phase_experiments(errs, times):
    """Phase 13; returns the entry points' launch counts."""
    import torch
    from rgqa_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for b in (384, 7):
            for case in _exp_cases(b, dtype, gen):
                got, want, shipped = case.kernel(), case.plain(), case.shipped()
                torch.cuda.synchronize()
                outs = got if isinstance(got, tuple) else (got,)
                msg = ", ".join(_compare(case.name, dtype, a, w, errs).split(" ", 1)[1]
                                for a, w in zip(outs, want if isinstance(want, tuple) else (want,)))
                # The shipped composition, a second check of the plain version.
                ship = shipped if isinstance(shipped, tuple) else (shipped,)
                if case.exact:
                    if not all(torch.equal(a, s) for a, s in zip(outs, ship)):
                        raise AssertionError(f"{case.name} {case.label} differs from two #1 calls")
                    sdiff = 0.0
                else:
                    # Twice the bound: kernel and shipped form each lie within
                    # it of the plain version, rounding in their own places.
                    sdiff = max(float((a.float() - s.float()).abs().max()) for a, s in zip(outs, ship))
                    atol, rtol = (2 * x for x in _tol(case.name, "out", dname))
                    if not all(bool(((a.float() - s.float()).abs() <= atol + rtol * s.float().abs()).all())
                               for a, s in zip(outs, ship)):
                        raise AssertionError(f"{case.name} {case.label} {dname} B={b}: max|kernel-shipped| "
                                             f"{sdiff:.3e} over {atol} + {rtol}|shipped|")
                log("experiments", f"{dname} B={b} {case.name} {case.label}: max|kernel-plain| {msg}; "
                    f"max|kernel-shipped| {sdiff:.3e}" + (" (bit for bit)" if case.exact else ""))
            torch.cuda.empty_cache()

    # Times at batch 384 bf16 (and the pair's forms at batch 32).
    for b in (384, 32):
        for case in _exp_cases(b, torch.bfloat16, gen):
            if b == 32 and case.name not in ("dual_pair", "cat_call"):
                continue
            shipped_ms, kernel_ms = in_turns(case.shipped, case.kernel, iters=EXP_ITERS)
            bound, by = _bound(case.nbytes, case.flops)
            row = {"kernel": kernel_ms, "shipped": shipped_ms, "bound": bound, "bound_by": by}
            if b == 384:  # yardsticks, timed once each
                row["plain"] = cuda_ms(case.plain, iters=EXP_ITERS)
                row["library"] = cuda_ms(case.library, iters=EXP_ITERS)
                times.setdefault(case.name, []).append(row)
            log("experiments", f"bf16 B={b} {case.name} {case.label}: us " + ", ".join(
                f"{k} {v * 1e3:.1f}" for k, v in row.items() if k != "bound_by") + f" (bound by {by})")
        torch.cuda.empty_cache()

    launches = _run_experiments()
    _held_shapes(att, gen, errs)
    return launches


# ---------------------------------------------------------------------------
# Phases 14-15: the rejection scorers (slice 10).
# ---------------------------------------------------------------------------


def _scorer_launches(name: str, enc, passes: int) -> dict:
    """Kernel launches per batch of 256 of each LXMERT scorer (see the
    docstring, phase 14)."""
    per_forward = enc.l_layers + enc.r_layers + 4 * enc.x_layers  # 34
    bwd = enc.r_layers + 4 * (enc.x_layers - 1) + 2  # 23: on a path from the RoI inputs to pooled
    want = {k: 0 for k in KERNELS}
    if name in ("odin", "maha_noised"):
        want.update(fused_attention=2 * per_forward, fused_attention_bwd=bwd)
    elif name == "dropout":
        want["fused_attention_dropout"] = passes * per_forward
    else:
        want["fused_attention"] = per_forward
    return want


def _fit_batches(cfg, forward, n: int, classes: int):
    """``n`` batches of 256 with padded text, on the card, each row's
    one-hot target the class of its pooled feature (``forward``'s):
    the largest of ``classes`` seeded random projections of the feature
    less the mean over all rows.  Classes the features separate, as a
    trained model's answers are: with random targets the class means
    differ by sampling noise alone, which the precision amplifies, and
    the top-2 gap of most rows sits at bf16 round-off whichever path
    computes it."""
    import torch
    from rgqa_tpu_torch.data.batching import to_device
    from rgqa_tpu_torch.models.zoo import example_batch

    out = [to_device(_padded_text(example_batch(cfg, 256, seed=40 + i), seed=50 + i), "cuda")
           for i in range(n)]
    with torch.no_grad():
        pooled = torch.stack([forward(b, deterministic=True)["pooled"].float() for b in out])
    proj = torch.randn(pooled.shape[-1], classes, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(90))
    cls = ((pooled - pooled.mean(dim=(0, 1))) @ proj).argmax(-1)  # (n, 256)
    for b, c in zip(out, cls):
        b["target"] = torch.nn.functional.one_hot(c, cfg.num_answers).float()
    return out, torch.bincount(cls.flatten(), minlength=classes)


def _recording(fwd):
    """``fwd`` keeping, of each call made outside autograd (a scorer's
    scoring pass), the f32 pooled output, and of each call inside it (its
    gradient pass), the gradient that reaches ``feats`` and ``boxes`` and
    the f32 logits and pooled output."""
    import torch

    pooled, grads = [], []

    def forward(batch, **kw):
        record = torch.is_grad_enabled() and batch["feats"].requires_grad
        if record:
            got = {}
            grads.append(got)
            for key in ("feats", "boxes"):
                batch[key].register_hook(lambda g, key=key: got.__setitem__(key, g.detach().clone()))
        out = fwd(batch, **kw)
        if record:
            got.update(logits=out["logits"].detach().float(), pooled=out["pooled"].detach().float())
        else:
            pooled.append(out["pooled"].float())
        return out

    return forward, pooled, grads


def _grad_check(gk: list, gp: list, same: list, rtol: float) -> tuple[list, str]:
    """The input gradients of the kernels' path against the plain path's
    (per batch, ``feats`` and ``boxes``), on the rows ``same`` where both
    paths' gradient passes made the same decision (elsewhere the loss is
    another function and so is its gradient; it must be
    ``MIN_LABEL_AGREEMENT`` of the rows): relative L2 error at most
    ``rtol``, and no sign01 flip above ``GRAD_SIGN_FLOOR`` of the largest
    |g_plain|.  Returns (faults, a line of the numbers)."""
    import torch

    rows, total = sum(int(m.sum()) for m in same), sum(m.numel() for m in same)
    faults, parts = [], [f"rows of the same decision {rows} of {total}"]
    if rows < MIN_LABEL_AGREEMENT * total:
        faults.append(f"the gradient passes decide alike on {rows} of {total} rows")
    for key in ("feats", "boxes"):
        k = torch.cat([g[key][m].flatten() for g, m in zip(gk, same)]).double()
        p = torch.cat([g[key][m].flatten() for g, m in zip(gp, same)]).double()
        scale = p.abs().max().item() if p.numel() else 0.0
        rel = ((k - p).norm() / p.norm()).item() if scale > 0 else math.inf
        flips = (k >= 0) != (p >= 0)
        above = flips & (p.abs() > GRAD_SIGN_FLOOR * scale)
        worst = (p.abs()[flips].max().item() / scale) if flips.any() and scale > 0 else 0.0
        parts.append(f"g_{key}: max|plain| {scale:.3e}, relative L2 error {rel:.3e} (bound {rtol:.2g}), "
                     f"sign flips {int(flips.sum())} of {flips.numel()} (largest at {worst:.3e} of max|g|; "
                     f"{int(above.sum())} above {GRAD_SIGN_FLOOR:.0e})")
        if not scale > 0:
            faults.append(f"no gradient reached {key}")
        if not rel <= rtol:
            faults.append(f"g_{key} relative error {rel:.3e}")
        if above.any():
            faults.append(f"g_{key}: {int(above.sum())} sign flips above round-off")
    return faults, "; ".join(parts)


def phase_scorers() -> None:
    """Each scorer at full-width LXMERT, bf16, batch 256, through the
    kernels and through the plain versions: launches per batch, agreement,
    input gradients, questions/s (phase 14)."""
    import torch
    from rgqa_tpu_torch.data.batching import to_device
    from rgqa_tpu_torch.models.zoo import build_model, default_config, example_batch
    from rgqa_tpu_torch.scorers import make_scorer
    from rgqa_tpu_torch.scorers.maha import _gaussian_scores, accumulate_moments, estimator_from_moments

    cfg = default_config()
    enc = cfg.encoder
    model, forward = build_model(cfg, use_bf16=True, device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(0))
    plain = lambda batch, **kw: forward(batch, use_fused=False, **kw)  # noqa: E731
    batches = [to_device(_padded_text(example_batch(cfg, 256, seed=70 + i), seed=80 + i), "cuda")
               for i in range(SCORE_BATCHES)]

    # The Mahalanobis fit: pooled features of FIT_BATCHES train-like
    # batches through the kernels (eval mode), accumulated on the card;
    # the rows' classes from the plain path's features.
    fit, class_rows = _fit_batches(cfg, plain, FIT_BATCHES, FIT_CLASSES)

    def pooled(fwd):
        for b in fit:
            with torch.no_grad():
                yield fwd(b, deterministic=True)["pooled"], b["target"]

    def timed_fit(fwd):
        """(estimator, ms per train batch of the pass on the card, ms of
        the host's covariance and pinvh, paid once per fit)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moments = accumulate_moments(pooled(fwd), cfg.num_answers, enc.hidden_size)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        est = estimator_from_moments(*moments)
        return est, (t1 - t0) * 1e3 / FIT_BATCHES, (time.perf_counter() - t1) * 1e3

    timed_fit(forward)  # warm-up
    reset_counts()
    est, fit_ms, once_ms = timed_fit(forward)
    fit_counts = read_counts()
    _, fit_ms_plain, _ = timed_fit(plain)
    eig = torch.linalg.eigvalsh(est.precision.double())
    log("scorers", f"Mahalanobis fit on {FIT_BATCHES} batches of 256 ({FIT_CLASSES} classes): wall per "
        f"train batch (forward and the sums on the card) {fit_ms:.3f} ms through the kernels, "
        f"{fit_ms_plain:.3f} plain; once per fit (the host's covariance and pinvh) {once_ms:.3f} "
        f"ms; launches {fit_counts['fused_attention']} of #1 (want {34 * FIT_BATCHES}); rows per class "
        f"{class_rows.min().item()} .. {class_rows.max().item()}; precision eigenvalues "
        f"{eig.min().item():.3e} .. {eig.max().item():.3e}")
    if fit_counts != {**{k: 0 for k in KERNELS}, "fused_attention": 34 * FIT_BATCHES}:
        raise AssertionError(f"the fit launched {fit_counts}")
    if not (torch.isfinite(est.precision).all() and torch.isfinite(est.class_mean).all()):
        raise AssertionError("the fitted estimator is not finite")
    if model.training:
        raise AssertionError("the fit left the model in training mode")

    def odin_decision(rec):  # the argmax column and its pseudo-label
        idx = rec["logits"].argmax(-1)
        return 2 * idx + (rec["logits"].gather(-1, idx[:, None])[:, 0] >= 0)

    def maha_decision(rec):  # the top class
        return _gaussian_scores(rec["pooled"], est.class_mean, est.precision).argmax(-1)

    decisions = {"odin": odin_decision, "maha": maha_decision}
    opts = dict(seed_list=SEED_LIST, estimator=est)
    kinds = {"msp": ("msp", {}), "energy": ("energy", {}),
             "odin": ("odin", {"temperature": ODIN_T, "noise": ODIN_NOISE}),
             "maha": ("maha", {}), "maha_noised": ("maha", {"noise": MAHA_NOISE}),
             "dropout": ("dropout", {})}
    faults, maha_scores = [], {}
    for name, (kind, extra) in kinds.items():
        rec_k, pooled_k, grads_k = _recording(forward)
        rec_p, pooled_p, grads_p = _recording(plain)
        check_k = make_scorer(kind, rec_k, **opts, **extra)
        check_p = make_scorer(kind, rec_p, **opts, **extra)
        check_k(batches[0])  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        pooled_k.clear()
        grads_k.clear()
        out_k = [check_k(b) for b in batches]
        torch.cuda.synchronize()
        counts = read_counts()
        out_p = [check_p(b) for b in batches]
        torch.cuda.synchronize()
        if read_counts() != counts:
            raise AssertionError(f"{name}: the plain versions launched a kernel")
        if model.training:
            raise AssertionError(f"{name} left the model in training mode")
        launched = {k: v / SCORE_BATCHES for k, v in counts.items()}
        want = _scorer_launches(name, enc, len(SEED_LIST))
        lk = torch.cat([o["label"] for o in out_k])
        lp = torch.cat([o["label"] for o in out_p])
        sk = torch.cat([o["score"] for o in out_k]).float()
        sp = torch.cat([o["score"] for o in out_p]).float()
        diff = (sk - sp).abs()
        agree = (lk == lp).float().mean().item()
        extra_line, bad = "", []
        # Scores are held on every row, but for ODIN and noised
        # Mahalanobis on the rows whose gradient passes decided alike:
        # elsewhere the perturbation descends another loss, and the two
        # paths score different inputs.
        held = torch.ones_like(sk, dtype=torch.bool)
        if len(grads_k) != len(grads_p):
            bad.append(f"{len(grads_k)} gradient passes through the kernels, {len(grads_p)} plain")
        elif grads_p:
            same = [decisions[kind](k) == decisions[kind](p) for k, p in zip(grads_k, grads_p)]
            held = torch.cat(same)
            bad_g, line = _grad_check(grads_k, grads_p, same, GRAD_RTOL[kind])
            bad += bad_g
            extra_line += f"; input gradient: {line}"
        atol, rtol = SCORE_TOL.get(name, SCORE_TOL[kind])
        excess = (diff - atol - rtol * sp.abs())[held].max().item()
        if kind == "maha":
            dpool = (torch.cat(pooled_k) - torch.cat(pooled_p)).abs().max().item()
            extra_line += f"; max|pooled kernel-plain| {dpool:.3e} (bound {POOLED_TOL:.0e})"
            if not dpool <= POOLED_TOL:
                bad.append(f"pooled features differ by {dpool:.3e}")
            maha_scores[name] = sk
        # Timed without the recording (its copies and hooks are not the
        # scorer's work).
        score_k = make_scorer(kind, forward, **opts, **extra)
        score_p = make_scorer(kind, plain, **opts, **extra)
        plain_ms, kernel_ms = in_turns(lambda: score_p(batches[0]), lambda: score_k(batches[0]),
                                       iters=SCORER_ITERS[kind], warmup=2)
        log("scorers", f"{name}: launches per batch {({k: v for k, v in launched.items() if v})} "
            f"(want {({k: v for k, v in want.items() if v})}); labels agree on {agree:.4f} "
            f"(want >= {MIN_LABEL_AGREEMENT}); max|score kernel-plain| {diff.max().item():.3e}, "
            f"scores {sp.min().item():.7g} .. {sp.max().item():.7g} (bound {atol:.1e} + {rtol:.0e} "
            f"|plain| on {int(held.sum())} rows; worst excess {excess:.3e}){extra_line}; ms per batch "
            f"of 256 (in turns): kernels {kernel_ms:.3f} ({256e3 / kernel_ms:.1f} q/s), plain "
            f"{plain_ms:.3f} ({256e3 / plain_ms:.1f} q/s)")
        if launched != want:
            bad.append(f"launches per batch {launched}, want {want}")
        if not torch.isfinite(sk).all() or lk.shape != (256 * SCORE_BATCHES,):
            bad.append("scores not finite / wrong shape")
        if agree < MIN_LABEL_AGREEMENT or excess > 0:
            bad.append("kernel and plain scores disagree")
        faults += [f"{name}: {b}" for b in bad]
    if torch.equal(maha_scores["maha_noised"], maha_scores["maha"]):
        faults.append("maha_noised: the perturbation moved no score")
    if faults:
        raise AssertionError("; ".join(faults))
    del model, forward, batches, fit, est
    torch.cuda.empty_cache()


def _favoured_pth(path: str, root: str, seed: int, favour: bool) -> str:
    """A seeded full-width LXMERT as a reference ``.pth``; ``favour``
    raises the answer bias of testdev's most frequent answer, so the
    random model answers some questions right (``--target_acc`` needs a
    reachable accuracy)."""
    import collections

    import torch
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.models.zoo import build_model, default_config
    from rgqa_tpu_torch.train.state import save_reference_pth

    ds = GQADataset(root, "testdev", add_uq=True)
    cfg = dataclasses.replace(default_config(), num_answers=ds.num_answers - 1)
    model, _ = build_model(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
    if favour:
        top = collections.Counter(a for d in ds.data for a in d["label"] if a != "UQ").most_common(1)[0][0]
        with torch.no_grad():
            model.answer_head.logits.bias[ds.label2ans.index(top)] += 8.0
    save_reference_pth(model, cfg, path)
    del model
    return path


def _check_scored_outputs(phase, out_dir, root, results, argv, seconds, launches, want) -> dict:
    """A scorer run of the evaluate CLI: one row per question with a
    known answer and a finite confidence, the metric dict, and the
    launches ``want``.  Returns ``{qid: (answer, confidence)}``."""
    from rgqa_tpu_torch.data.dataset import GQADataset

    with open(os.path.join(out_dir, "testdev_predict.json")) as f:
        preds = json.load(f)
    ds = GQADataset(root, "testdev", add_uq=True)
    shown = {k: v for k, v in launches.items() if v}
    log(phase, f"evaluate CLI ({' '.join(argv)}) in {seconds:.2f} s: launches {shown}")
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    if "tau" in results:  # --target_acc: {qid: [answer, confidence]}
        rows = {q: tuple(v) for q, v in preds.items()}
        if not (math.isfinite(results["tau"]) and any(a == "UQ" for a, _ in rows.values())):
            raise AssertionError(f"--target_acc gave tau {results['tau']} and no rejection")
        log(phase, f"tau {results['tau']:.6f}; {sum(a == 'UQ' for a, _ in rows.values())} of "
            f"{len(rows)} answers rejected")
    else:
        rows = {p["questionId"]: (p["prediction"], p["confidence"]) for p in preds}
        for key in ("auaf", "fpr@0.95acc", "full_acc"):
            if not isinstance(results.get(key), float) or math.isnan(results[key]):
                raise AssertionError(f"metric {key} missing or NaN: {results}")
        log(phase, "metrics: " + ", ".join(f"{k} {results[k]:.6f}" for k in ("auaf", "fpr@0.95acc", "full_acc")))
    if len(rows) != len(preds) or sorted(rows) != sorted(d["question_id"] for d in ds.data):
        raise AssertionError("prediction JSON does not hold one row per question")
    if not all(math.isfinite(c) and a in ds.label2ans for a, c in rows.values()):
        raise AssertionError("prediction JSON holds an invalid confidence or answer")
    return rows


def _plain_rescore(phase, argv, root, rows, kind) -> None:
    """Re-score the split as the CLI run ``argv`` did (its runner, its
    weights, its options, the same ``sample_estimates.pkl``) with every
    attention call through the plain version; hold the CLI's answers and
    confidences ``rows`` to it (``SCORE_TOL[kind]``, plus the 1e-4 step
    of the prediction JSON's rounded confidences; ``kind`` None: the
    answers alone)."""
    import torch
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.data.dataset import GQADataset

    before = read_counts()
    cfg, device, plan = evaluate.parse_args(argv)
    runner = evaluate.make_runner(cfg, device, plan["scorer"])
    fused = runner.forward
    runner.forward = lambda batch, **kw: fused(batch, use_fused=False, **kw)
    encoded = runner._encode(GQADataset(root, "testdev", add_uq=True))
    if plan["target_acc"] is not None:
        plain = runner.predict_with_thresh(encoded)["quesid2ans"]
    elif plan["scorer"] == "ensemble":
        path = os.path.join(cfg.output, "plain_predict.json")
        runner.ensemble_ood_evaluate(encoded, plan["ensemble"], dump=path)
        with open(path) as f:
            plain = {p["questionId"]: (p["prediction"], p["confidence"]) for p in json.load(f)}
    else:
        plain = runner.score_split(encoded)
    torch.cuda.synchronize()
    if read_counts() != before:
        raise AssertionError(f"{phase}: the plain re-score launched a kernel")
    agree = sum(rows[q][0] == a for q, (a, _) in plain.items()) / len(plain)
    dconf = max(abs(rows[q][1] - c) for q, (_, c) in plain.items())
    drel = max(abs(rows[q][1] - c) / max(abs(c), 1e-30) for q, (_, c) in plain.items())
    if kind is None:
        excess, bound = -math.inf, "not held: see phase_scorer_cli"
    else:
        atol, rtol = SCORE_TOL[kind]
        if plan["target_acc"] is None:
            atol += 1e-4  # the prediction JSON's confidences are rounded to 4 dp
        excess = max(abs(rows[q][1] - c) - atol - rtol * abs(c) for q, (_, c) in plain.items())
        bound = f"bound {atol:.1e} + {rtol:.0e} |plain|; worst excess {excess:.3e}"
    log(phase, f"vs plain attention: answers agree on {agree:.4f} of questions (want >= "
        f"{MIN_LABEL_AGREEMENT}), max|confidence diff| {dconf:.3e}, relative {drel:.3e} ({bound})")
    if sorted(plain) != sorted(rows):
        raise AssertionError(f"{phase}: the plain re-score scored other questions")
    if agree < MIN_LABEL_AGREEMENT or excess > 0:
        raise AssertionError(f"{phase}: the CLI's answers disagree with the plain re-score")
    del runner
    torch.cuda.empty_cache()


def phase_scorer_cli() -> None:
    """The evaluate CLI with each new scorer flag at full width, batch
    256, each run held to a plain re-score (phase 15)."""
    import torch
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa

    seeds = ["--seed_list", ",".join(map(str, SEED_LIST))]
    s = len(SEED_LIST)
    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_scorers_") as tmp:
        root, maha_root = os.path.join(tmp, "gqa"), os.path.join(tmp, "gqa_maha")
        make_synthetic_gqa(root)
        # The Mahalanobis fit needs many more labeled train rows than the
        # 768 dimensions, or its precision blows up round-off (phase 14).
        make_synthetic_gqa(maha_root, SyntheticSpec(**MAHA_ROOT))
        a = _favoured_pth(os.path.join(tmp, "a.pth"), root, 1, favour=True)
        b = _favoured_pth(os.path.join(tmp, "b.pth"), root, 2, favour=False)
        n = math.ceil(len(GQADataset(root, "testdev", add_uq=True)) / 256)  # scored batches
        n_maha = math.ceil(len(GQADataset(maha_root, "testdev", add_uq=True)) / 256)
        fits = math.ceil(len(GQADataset(maha_root, "train", add_uq=True)) / 256)  # the fit's batches
        target = f"{_reachable_acc(root) / 2:.6f}"

        def want(**counts):
            return {**{k: 0 for k in KERNELS}, **counts}

        grad = dict(fused_attention=68 * n, fused_attention_bwd=23 * n)
        grad_maha = dict(fused_attention=68 * n_maha, fused_attention_bwd=23 * n_maha)
        odin = ["--temperature", str(ODIN_T), "--noise", str(ODIN_NOISE)]
        maha = ["--scorer", "maha", "--noise", str(MAHA_NOISE), "--load", a]
        # (name, scorer kind of SCORE_TOL, flags, launches).  The
        # Mahalanobis runs' scores are not held to the plain re-score:
        # the synthetic answers do not separate a random model's pooled
        # features, so the fitted precision amplifies their bf16
        # round-off into the scores (phase 14 holds the scores, with
        # classes the features separate).  Their answers are held, and
        # the second run, which reads the first run's estimator back,
        # must give the first run's prediction JSON bit for bit.
        runs = [
            ("energy", "energy", ["--scorer", "energy", "--load", a], want(fused_attention=34 * n)),
            ("odin", "odin", ["--scorer", "odin", *odin, "--load", a], want(**grad)),
            ("dropout", "dropout", ["--scorer", "dropout", *seeds, "--load", a],
             want(fused_attention_dropout=34 * s * n)),
            ("maha", None, maha, want(**dict(grad_maha, fused_attention=34 * fits + 68 * n_maha))),
            ("maha-cached", None, maha, want(**grad_maha)),
            ("target_acc", "msp", ["--target_acc", target, "--load", a], want(fused_attention=34 * n)),
            ("ensemble", "ensemble", ["--load", f"{a},{b}"], want(fused_attention=2 * 34 * n)),
            ("vilt-dropout", "dropout", ["--backbone", "vilt", "--scorer", "dropout", *seeds],
             want(fused_attention_long=12 * s * n)),
            ("vilt-energy", "energy", ["--backbone", "vilt", "--scorer", "energy"],
             want(fused_attention_long=12 * n)),
        ]
        for name, kind, extra, launches in runs:
            out_dir = os.path.join(tmp, "out_" + name.removesuffix("-cached"))
            data = maha_root if name.startswith("maha") else root
            argv = ["--synthetic", "--data_root", data, *extra, "--test", "testdev",
                    "--batchSize", "256", "--output", out_dir]
            reset_counts()
            t0 = time.perf_counter()
            results = evaluate.main(argv)["testdev"]
            torch.cuda.synchronize()
            rows = _check_scored_outputs("scorer-cli", out_dir, data, results, argv,
                                         time.perf_counter() - t0, read_counts(), launches)
            if name == "maha" and not os.path.isfile(os.path.join(out_dir, "sample_estimates.pkl")):
                raise AssertionError("--scorer maha wrote no sample_estimates.pkl")
            if name == "maha":
                fitted = rows
            if name == "maha-cached" and rows != fitted:
                raise AssertionError("--scorer maha with the cached estimator changed the predictions")
            _plain_rescore("scorer-cli", argv, data, rows, kind)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 16-17: data preparation and the scoring service (slice 12).
# ---------------------------------------------------------------------------


def _files(directory) -> dict:
    return {name: open(os.path.join(directory, name), "rb").read() for name in sorted(os.listdir(directory))}


def phase_prepare(tmp: str) -> tuple[str, str]:
    """The packer and the prepare-data CLI (phase 16); returns (the
    synthetic root, the prepared root)."""
    import numpy as np
    from rgqa_tpu_torch.cli import prepare_data
    from rgqa_tpu_torch.data.synthetic import make_synthetic_gqa
    from rgqa_tpu_torch.data.tsv import PackedFeatures, pack_obj_tsv, write_obj_tsv

    synth, prepared = os.path.join(tmp, "gqa"), os.path.join(tmp, "gqa_prepared")
    make_synthetic_gqa(synth)
    pack = PackedFeatures(os.path.join(synth, "features"))
    names = ("objects_id", "objects_conf", "attrs_id", "attrs_conf", "boxes", "features")
    rows = [dict({k: getattr(pack, k)[i] for k in names}, img_id=img_id, img_h=pack.sizes[i, 0],
                 img_w=pack.sizes[i, 1]) for i, img_id in enumerate(pack.img_ids)]
    extra = LONG_ROW_BOXES - len(rows[0]["boxes"])  # boxes past 36 on the first image: truncated
    rows[0] = dict(rows[0], **{k: np.concatenate([v, v[:extra] * 0.5 + 1.0]) for k, v in rows[0].items()
                               if k in names})
    short = {k: v[:SHORT_ROW_BOXES] for k, v in rows[1].items() if k in names}
    rows.append(dict(short, img_id="short_row", img_h=300, img_w=400))  # zero-padded to 36
    tsv_path = os.path.join(tmp, "obj.tsv")
    nbytes = write_obj_tsv(tsv_path, rows)
    t0 = time.perf_counter()
    packed = pack_obj_tsv(tsv_path, os.path.join(tmp, "pack"))
    wall = time.perf_counter() - t0
    n = len(pack.img_ids)
    for name in PackedFeatures.ARRAYS:
        if not np.array_equal(getattr(packed, name)[:n], getattr(pack, name)):
            raise AssertionError(f"the pack's {name} differs from the synthetic pack's")
    if packed.img_ids[-1] != "short_row" or packed.features[n, SHORT_ROW_BOXES:].any():
        raise AssertionError("the short row is not zero-padded")
    log("prepare", f"TSV of {len(rows)} rows ({nbytes / 1e6:.1f} MB; boxes {LONG_ROW_BOXES} on one "
        f"row, {SHORT_ROW_BOXES} on one) packed in {wall:.3f} s; the pack holds the synthetic pack")
    t0 = time.perf_counter()
    done = prepare_data.main(["--tsv", tsv_path, "--json_dir", synth, "--vocab",
                              os.path.join(synth, "vocab.txt"), "--out", prepared])
    if _files(os.path.join(prepared, "features")) != _files(os.path.join(tmp, "pack")):
        raise AssertionError("prepare_data wrote another feature pack than pack_obj_tsv")
    log("prepare", f"prepare_data wrote {prepared} ({done['images']} images) in "
        f"{time.perf_counter() - t0:.3f} s: {sorted(os.listdir(prepared))}")
    return synth, prepared


def _serve_stream(root: str) -> tuple[list, list]:
    """The phase-17 stream: good records, the four bad lines, two records
    sharing a question id; returns (lines, the records that score, in
    order)."""
    from rgqa_tpu_torch.data.synthetic import serve_records

    with open(os.path.join(root, "testdev.json")) as f:
        rows = json.load(f)
    good = serve_records(rows, SERVE_RECORDS)
    shared = [json.dumps({"question_id": "shared", "sent": r["sent"], "img_id": r["img_id"]})
              for r in rows[:2]]
    bad = ["{not json", "[1, 2]", json.dumps({"sent": "what is it ?"}),
           json.dumps({"question_id": "q_unknown", "sent": "what is it ?", "img_id": "no_such_image"})]
    half = SERVE_RECORDS // 2
    scored = good[:half] + shared + good[half:]
    return good[:half] + bad + shared + good[half:], [json.loads(line) for line in scored]


def _served(phase, lines, out, stats, good) -> list:
    """Hold one serve run's output: a line per record, the four errors,
    a finite answer per good record in their order (the two of the
    shared id both answered), ``--serve_stats`` counting each; returns
    the answers."""
    rows = [json.loads(line) for line in out]
    errors = [r for r in rows if "error" in r]
    answers = [r for r in rows if "error" not in r]
    if len(rows) != len(lines) or len(errors) != len(lines) - len(good):
        raise AssertionError(f"{phase}: {len(rows)} lines ({len(errors)} errors) for {len(lines)} records")
    if [r["questionId"] for r in answers] != [g["question_id"] for g in good]:
        raise AssertionError(f"{phase}: the answers are not one per good record, in order")
    if not all(math.isfinite(r["confidence"]) for r in answers):
        raise AssertionError(f"{phase}: a confidence is not finite")
    if stats is not None and stats["count"] != len(good):
        raise AssertionError(f"{phase}: --serve_stats counted {stats['count']} records, {len(good)} scored")
    return answers


def phase_serve(tmp: str, synth: str, prepared: str) -> None:
    """The scoring service at full width on the prepared root (phase 17)."""
    import torch
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.cli.serve import serve_lines
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.data.synthetic import serve_records
    from rgqa_tpu_torch.runner import GQARunner
    from rgqa_tpu_torch.scorers.core import make_msp_scorer

    lines, good = _serve_stream(prepared)
    forwards = math.ceil(len(good) / 256)
    flags = ["--test", "testdev", "--batchSize", "256", "--wave_timeout", "0", "--serve_stats"]

    def run(name, argv, want):
        reset_counts()
        t0 = time.perf_counter()
        out, stats, _ = serve_lines(argv, lines)
        torch.cuda.synchronize()
        launches = read_counts()
        answers = _served(f"serve {name}", lines, out, stats, good)
        log("serve", f"{name} ({' '.join(argv)}) in {time.perf_counter() - t0:.2f} s: {len(out)} lines, "
            f"{len(good)} answered; launches {({k: v for k, v in launches.items() if v})}; latency {stats}")
        if launches != {**{k: 0 for k in KERNELS}, **want}:
            raise AssertionError(f"serve {name}: launches {launches}, want {want}")
        return out, answers

    argv = ["--data_root", prepared, "--scorer", "msp", *flags, "--output", os.path.join(tmp, "serve_msp")]
    out, answers = run("lxmert msp, prepared root", argv, {"fused_attention": 34 * forwards})
    synth_out, _ = run("lxmert msp, synthetic root", ["--synthetic", "--data_root", synth, "--scorer", "msp",
                                                      *flags, "--output", os.path.join(tmp, "serve_synth")],
                       {"fused_attention": 34 * forwards})
    if synth_out != out:
        raise AssertionError("serve on the prepared root answers otherwise than on the synthetic root")

    # The same rows re-scored by the same runner through the plain version.
    cfg, ns = parse_cli(argv)
    runner = evaluate.make_runner(cfg, ns.device, "msp")
    fused = runner.forward
    plain_forward = lambda batch, **kw: fused(batch, use_fused=False, **kw)  # noqa: E731
    vocab = runner.dataset
    ds = GQADataset.from_rows([dict(r, label={}) for r in good], ans2label=vocab.ans2label,
                              label2ans=vocab.label2ans, name="plain")
    before = read_counts()
    plain = runner.score_rows(runner._encode(ds), scorer=make_msp_scorer(plain_forward))
    torch.cuda.synchronize()
    if read_counts() != before or len(plain) != len(answers):
        raise AssertionError("the plain re-score launched a kernel or scored other rows")
    agree = sum(a["prediction"] == p for a, (p, _) in zip(answers, plain)) / len(plain)
    dconf = max(abs(a["confidence"] - c) for a, (_, c) in zip(answers, plain))
    log("serve", f"vs plain attention: labels agree on {agree:.4f} of records (want >= "
        f"{MIN_LABEL_AGREEMENT}), max|confidence diff| {dconf:.3e} (bound {CONF_TOL:.0e} + 1e-4, the 4 dp step)")
    if agree < MIN_LABEL_AGREEMENT or not dconf <= CONF_TOL + 1e-4:
        raise AssertionError("serve disagrees with the plain re-score")
    del runner, fused
    torch.cuda.empty_cache()

    # Mahalanobis under bf16 compute: the fit reads f32 weights.
    fitted = []
    fit = GQARunner.fit_maha_estimator

    def recording_fit(self):
        fitted.append(({str(p.dtype) for p in self.model.parameters()}, self.cfg.train.use_bf16))
        return fit(self)

    fits = math.ceil(len(GQADataset(prepared, cfg.data.train_splits, add_uq=True)) / 256)
    GQARunner.fit_maha_estimator = recording_fit
    try:
        run("lxmert maha", ["--data_root", prepared, "--scorer", "maha", *flags,
                            "--output", os.path.join(tmp, "serve_maha")],
            {"fused_attention": 34 * (fits + forwards)})
    finally:
        GQARunner.fit_maha_estimator = fit
    log("serve", f"maha: the fit read weights of {fitted} (dtypes, bf16 compute)")
    if fitted != [({"torch.float32"}, True)]:
        raise AssertionError(f"the Mahalanobis fit under serve read {fitted}, want f32 weights under bf16")
    if not os.path.isfile(os.path.join(tmp, "serve_maha", "sample_estimates.pkl")):
        raise AssertionError("serve --scorer maha wrote no sample_estimates.pkl")

    run("vilt msp, synthetic root", ["--backbone", "vilt", "--synthetic", "--data_root", synth, "--scorer",
                                     "msp", *flags, "--output", os.path.join(tmp, "serve_vilt")],
        {"fused_attention_long": 12 * forwards})

    # The latency tier: records arriving one at a time, batch 8.
    with open(os.path.join(prepared, "testdev.json")) as f:
        stream = serve_records(json.load(f), LATENCY_RECORDS)

    def arriving():
        for line in stream:
            yield line
            time.sleep(LATENCY_INTERVAL)

    out, stats, _ = serve_lines(["--data_root", prepared, "--test", "testdev", "--batchSize", "8",
                              "--serve_stats", "--output", os.path.join(tmp, "serve_b8")], arriving())
    log("serve", f"latency tier, batch 8, one record every {LATENCY_INTERVAL} s: {len(out)} lines; "
        f"p50 {stats['p50_ms']} ms, p95 {stats['p95_ms']} ms, p99 {stats['p99_ms']} ms, max "
        f"{stats['max_ms']} ms ({stats['count']} records)")
    if len(out) != LATENCY_RECORDS or stats["count"] != LATENCY_RECORDS:
        raise AssertionError("the latency tier did not answer every record")
    torch.cuda.empty_cache()


def _reachable_acc(root: str) -> float:
    """The accuracy (the acc-fpr curve's: correct over answerable) of
    answering testdev's most frequent answer to every question."""
    import collections

    from rgqa_tpu_torch.data.dataset import GQADataset

    golds = [next(iter(d["label"]), "UQ") for d in GQADataset(root, "testdev", add_uq=True).data]
    answerable = [g for g in golds if g != "UQ"]
    return collections.Counter(answerable).most_common(1)[0][1] / len(answerable)


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
    phase_vilt_long()
    exp_times = {}
    exp_launches = phase_experiments(errs, exp_times)
    phase_scorers()
    phase_scorer_cli()
    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_serve_") as tmp:
        phase_serve(tmp, *phase_prepare(tmp))

    launches = {
        "fused_attention": eval_launches,  # the evaluate path
        "fused_attention_bwd": steps[0.0][0]["fused_attention_bwd"],  # dropout-off steps
        "fused_attention_dropout": train_launches["fused_attention_dropout"],  # the train CLI
        "fused_attention_dropout_bwd": train_launches["fused_attention_dropout_bwd"],
        "fused_attention_long": vilt_launches,  # the ViLT evaluate path
        "fused_attention_long_bwd": vilt_train_launches["fused_attention_long_bwd"],  # the ViLT train CLI
        **exp_launches,  # the experiment entry points
    }
    rows = []
    for name, (source, replaces) in KERNELS.items():
        if name in exp_times:
            # One bf16 call of each shape and variant, batch 384 (CUDA events).
            per = exp_times[name]
            rows.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": errs[(name, "bfloat16")],
                "ms": sum(t["kernel"] for t in per), "plain_ms": sum(t["plain"] for t in per),
                "bound_ms": sum(t["bound"] for t in per), "bound_by": per[-1]["bound_by"],
                "library_ms": sum(t["library"] for t in per),
            })
            continue
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
