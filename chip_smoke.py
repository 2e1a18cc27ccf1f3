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
   HGMMA or with spilled registers fails the phase.  A line gives
   the short f32 bodies' instances (#1 / #4
   ``fused_attention_fwd_short_f32<kDrop, kPerLane>``, #3 / #5
   ``fused_attention_bwd_short_f32<kDrop, kPerLane>``, one softmax key a
   lane up to 32 keys): registers and spills from ptxas, and the dynamic
   shared memory of their layouts at 20x20 (one key a lane), 36x36 and
   50x50, as the short bf16 bodies' line (reported, not held).  Since
   slice 26 a line gives the long f32 bodies' instances (#2 / 4L
   ``fused_attention_long_f32`` and ``_tiled_f32``, #3L / 5L
   ``long_bwd_{dq,dkv}_f32``): registers and spills, and blocks an SM
   from the sources' f32 occupancy entry points (reported, not held).
3. kernels: the six attention kernels of slices 1-23 against their plain
   PyTorch versions (4L / 5L: phase 51).  #2, the long-stream forward, and #3L, the long-stream
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
   #3L at 165, 185 and 277 tokens, batch 256, and 597 tokens, batch 64,
   f32 and bf16, #3L on the model's route, without dbias).  Slice 8
   redesigned #1 / #4's bf16 body (one pass in registers, the dropout
   mask drawn once per 16 keys): the checks above hold it as they held
   the first design, #1 and #4 are timed at batch 64 in bf16 too, and
   two runs of #1 and #4 at 36x36 give identical bits as well.  The
   f32 bodies of #1 / #4 and #3 / #5 (4 x 4 register tiles of exact f32
   FMAs since their redesign): the same checks hold them, and one line per
   LXMERT shape gives all four f32 kernels' CUDA-event times (kernel /
   plain / library) and the profiler's device time beside f32 SDPA's and
   the bound (``_bound_ms`` at the f32 rate).
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
18-22. UNITER (slice 14), full width (12 layers x 768 over 20 text
   tokens + 36 RoI features, a 56-token stream whose text pads sit in the
   middle of the keys), bf16: the forward at batch 256 (phase 4's checks,
   12 launches of #1 a forward); the evaluate CLI with ``--backbone
   uniter --scorer msp --batchSize 256`` (phase 5's, 12 of #1 a
   forward); the scorers through the evaluate CLI as phase 15 (energy,
   ODIN: 24 of #1 and 12 of #3 a batch, MC-dropout: 12 of #4 a pass,
   noised Mahalanobis fitted then read back, the ensemble), each
   re-scored through the plain versions; training steps as phases 8-9
   (12 launches of #1 and #3 a step at dropout 0 with the losses held to
   the plain versions', 12 of #4 and #5 at 0.1); the train CLI (RP,
   dropout 0.1, batch 32: 12 of #4 and #5 a step, 12 of #1 a validation
   forward), its ``BEST.pth`` / ``LAST.pth`` in GQA-UNITER's key format
   (``encoder.model.uniter.*`` + ``logit_fc.*``) and an evaluate of
   ``BEST.pth``; one serve wave (phase 17's stream, msp, batch 256: 12 of
   #1 a forward); and ``tools.profile_forward`` at batch 256 and for a
   training step (32 + RP), kernels and plain: device time by kernel
   class, the attention share and the idle share.  Phase 2 reports the
   short bf16 bodies' registers and spills (kNT 8: 37-64 keys, UNITER's
   56) and phase 3 checks #1 / #3 / #4 / #5 at 56x56 under UNITER's mask
   (and #4's mask at 56 keys) as at LXMERT's shapes.
23-27. BUTD and the caption matcher, full width.  BUTD
   (GloVe-300 rows at random init, a GRU-1024 over 40 front-padded
   tokens, 36 RoIs of 2048 + 4, the 2 x 1024 classifier over the root's
   answers) keeps f32 weights and products, no TF32, and launches none
   of the attention kernels (each of its phases asserts every count 0):
   23, its forward at batch 256 held to the same weights on the CPU
   (labels agree on ``BUTD_MIN_AGREEMENT`` of the rows, confidences
   within ``BUTD_CONF_TOL``); 24, the train CLI (RP, batch 32, the
   model's dropouts) whose ``BEST.pth`` is in GQA-BUTD's key format and
   loads back with no key missing or unused; 25, the evaluate CLI with
   msp, energy, ODIN, Mahalanobis (fitted, then read back), MC-dropout,
   ``--branched`` and an ensemble (``--load BEST.pth,LAST.pth``) from
   that run (a seeded branched ``.pth`` for ``--branched``), each re-scored by the same runner's options on
   the CPU (``BUTD_SCORE_TOL`` plus the 4 dp step; Mahalanobis and
   MC-dropout hold their answers and a rerun's JSON bit for bit, as
   the CPU's dropout draws are not the card's), and one serve wave.
   The caption matcher (BERT-base, 12 x 768 over 20 tokens of
   ``[CLS] caption [SEP] question [SEP]``, pads at the end of the keys),
   bf16: 26, training steps as phases 8-9 (batch 32, no RP, the binary
   loss; 12 launches of #1 and #3 a step at dropout 0 with the losses
   held to the plain versions' within ``CAPS_LOSS_RTOL``, 12 of #4 and
   #5 at 0.1); 27, the train
   CLI ``--strategy caption`` on the train split and its UQ pairs
   (dropout 0.1: 12 of #4 and #5 a step, 12 of #1 a validation
   forward), its ``LAST.pth`` a trained GQABERT
   (``encoder.*`` + ``logit_fc.*``); then the evaluate CLI ``--scorer
   caption --load <LAST.pth> --load_gqa <BUTD's BEST.pth> --ans_backbone
   butd`` (12 of #1 a matcher forward, none else), re-scored through the
   plain versions (answers equal, confidences within ``CONF_TOL``).
   Their times: ``tools.profile_forward --backbone butd | caps``.
28-31. CLIP and the LXMERT match scorer, full width.  28:
   CLIP ViT-B/32 (vision 12 x 768 over 49 patches + CLS at 224 px, text
   12 x 512 over 77 tokens, projection 512) in f32 from a seeded init at
   batch 256: 12 launches of #1 an image forward at 50x50 and none in the
   causal text tower (plain attention); the cosine held to the plain
   version and to the same weights on the CPU (``CLIP_COS_TOL``, TF32
   off), the features' relative errors printed, and the same bits with
   TF32 switched on around the call (the model holds it off); the scorer
   forward timed, kernels and plain.  Phase 3 also holds #1 at 50x50
   with no mask, f32 and bf16, batch 256, 32 and 7, to its plain
   version, and times it at batch 256 and 32 beside unmasked SDPA and
   the bound (CUDA events and device time).  29: the evaluate CLI ``--scorer clip
   --clip_path <a random full-width HF CLIP directory> --load <phase 9's
   BEST.pth> --fp32 --batchSize 256`` on phase 9's root, its CLIP pack
   ``pixels_clip_224/`` written by the run from the base images: 12
   launches of #1 a CLIP forward beside the answerer's 34; re-scored
   through the plain versions (answers equal, cosines within
   ``CLIP_COS_TOL`` plus the 4 dp step).  30: a random full-width
   ``model_LXRT.pth`` in the reference layout, loaded back with no key
   missing or unused, and the evaluate CLI ``--scorer match --loadLXMERT
   <it>`` from the same answerer: 34 launches of #1 a match forward
   beside the answerer's 34, f32, re-scored likewise
   (``MATCH_CONF_TOL``).  31: ``tools.profile_forward --backbone clip``
   at batch 256 (and 32 until slice 19): device time by kernel class,
   #1's share and the idle share.
32-34. the single-loader strategies and the coverage scorer, full
   width, on a synthetic root.  32: LXMERT steps at batch 32 for each
   of ``STRATEGY_STEPS`` (``mixup_v1``, ``treemix_v2`` with the root's
   TreeMix spans, ``treemix_both``, ``--branched``, ``--branched_layer``,
   the energy hinge with ``--mceLoss``, ``--uq_as_class`` with
   ``mixup_v1`` over 1843 answers), each from one init and one set of
   host draws per batch (``train.step.draw_mixup``): at dropout 0
   through the kernels and the plain versions (34 launches of #1 and
   ``BWD_PER_STEP`` of #3 a step, losses within ``LOSS_RTOL``), at
   dropout 0.1 through #4 / #5 (34 and ``BWD_PER_STEP`` a step), ms per
   step.  33: the train CLI with the commands of
   ``scripts/lxmert/train/{mixup,branched,energy,ood_finetune}.sh``
   (``--chart`` added on the last) and of UNITER's and BUTD's
   ``mixup.sh`` as ``tools/recipes.py`` lists them, one epoch each: launches of #4 / #5 a step and #1 a validation
   forward (BUTD none), a ``BEST.pth`` that loads back with no key
   missing or unused, the chart pickle.  34: the evaluate CLI
   ``--scorer frcnn`` from phase 9's ``BEST.pth`` (``--fp32``, batch
   256): 34 launches of #1 a batch and none else, answers equal a plain
   re-score, confidences the host's coverage computed again.  Phase 3
   also times #1's f32 body at LXMERT's four shapes under LXMERT's mask,
   batch 256, CUDA events and device time beside f32 SDPA's and the
   bound (the match scorer and ``--fp32`` answerers run it).
35-36. the train CLI's remaining strategies, full width, on a synthetic
   root.  35: LXMERT steps at batch 32 of VILLA (``--strategy adv``: a
   clean forward through #1, three inner passes), the dual-loader
   min-max (``resampling``, ``woods``: a forward pair on two batches),
   ``distill_online`` (a second full-width LXMERT, bf16 weights, eval
   mode, as the teacher; ``mixup_v1``) and ``weight`` (the weighted
   pairs), each from one init and one set of host draws
   (``tools/strategy_steps.py``): at dropout 0 through the kernels and
   the plain versions (losses within ``LOSS_RTOL``), launches per step
   at dropout 0 and 0.1 held to ``NEW_STEP_LAUNCHES``, the wall and then
   the device time per step (``torch.profiler``).  36: the train CLI with the
   commands of ``scripts/lxmert/train/{adv,resampling,poem,woods,
   distill_online,weight}.sh`` (``tools/recipes.py``), one epoch each on a root of 128 train
   questions (the teacher a vanilla
   run's ``LAST``; ``weight`` with a random full-width HF CLIP
   directory, its pixels from the root's CLIP pack): launches per step
   and per validation forward, finite losses, a ``LAST.pth`` that loads
   back whole; ``--loadLXMERTQA`` from a random full-width 9500-answer
   ``<prefix>_LXRT.pth`` and an ``all_ans.json`` written here, the
   printed loaded / zeroed counts held to the files and the runner's
   weights to the file's before its first step, then its epoch; one
   step of each ``--optim`` and of ``--bf16_moments`` (bf16 moments).
37-41. the CLIP weight model's training, the cartography distillation
   and the statement verifier (slice 19), full width, on a root of 128
   train questions.  37: the joint step of ``--strategy weight
   --update_weight_model`` (``train.step.make_weighted_clip_train_step``),
   LXMERT at batch 32 beside a random full-width ViT-B/32 CLIP whose
   vision tower trains through #1 forward and #3 backward at 50x50, in
   bf16 (the default) and under ``--fp32``: at dropout 0 through the
   kernels and the plain versions from one init (``loss`` and ``loss_w``
   within ``LOSS_RTOL``), launches a step ``WEIGHT_MODEL_LAUNCHES`` (80
   #1 and 76 #3 at dropout 0; 12 #1, 12 #3, 68 #4 and 64 #5 at 0.1),
   the wall and device time a step and the peak device memory.  38:
   ``scripts/lxmert/train/weight.sh --update_weight_model``'s train CLI,
   one epoch (launches a step and a validation forward; ``LAST.pth``,
   ``LAST_clip.pth`` and ``clip_params/``, the export equal to the
   trained tower and moved off ``--clip_path``), then the evaluate CLI
   ``--scorer clip --clip_path <out>/clip_params`` as phase 29.  39: the
   distillation CLI from that ``LAST.pth`` (MC-dropout passes through
   #4, one pass held to its plain version on the same seeds; the
   ensemble of two ``.pth`` teachers through #1).  40: the verifier's
   ``train`` (3 x 32 statements a step through #4 / #5 beside the
   answerer's #1) and ``ood_evaluate`` (#1), launches counted.  41:
   ``cli.compute_param`` for every backbone.  Phase 3 also holds #3 at
   50x50 (no mask, f32 and bf16, batch 256 and 32) to its plain version
   and times #1 and #3 there beside SDPA and the bound.
42-45. LXMERT pretraining, the VQA task and NLVR2 (slice 21), full
   width (49.1 s together on the H100).  42: the pretraining step
   (``LxmertPretraining``, 9500 answers, f32 masters and bf16 compute)
   at batch 256 on one set of host-drawn masks (BERT's special ids):
   at dropout 0 one step through
   the kernels and one through the plain versions from one init, the six
   losses within ``PRETRAIN_LOSS_RTOL`` and 34 launches of #1 and of #3
   (``PRETRAIN_LAUNCHES``: the RoI losses read the vision stream, so all
   34 calls take a backward); at dropout 0.1 34 of #4 and of #5 a step,
   the wall over 4 steps and the device time a step.  43: ``cli.pretrain``
   with ``scripts/lxmert/train/pretrain.sh``'s task flags on a synthetic
   root, one epoch, batch 32: its launches (34 #4 and #5 a step, 34 #1
   an eval batch), finite eval losses,
   ``BEST_EVAL_LOSS_LXRT.pth`` and ``Epoch00_LXRT.pth`` complete.  44:
   ``cli.vqa`` on a synthetic VQA root, ``--train train,nominival --valid
   minival --loadLXMERTQA <43>/BEST_EVAL_LOSS`` (answer rows through an
   ``all_ans.json``; the printed counts held), one epoch at batch 32 (34
   #4, 32 #5 a step, 34 #1 a validation forward); ``--test minival
   --load BEST.pth --fp32`` on the card and with ``--device cpu``
   (accuracies within ``VQA_ACC_TOL``), ``--test test``: dumps with one
   integer-id row per question.  45: ``Nlvr2Runner``, batch 32 (64
   encoder rows), one epoch on 128 synthetic pairs (34 #4, 32 #5 a step),
   ``evaluate`` and ``dump_csv`` (34 #1 a forward), one batch's f32 logits
   through the kernels and the plain versions within ``LOGIT_TOL``.
46-49. data parallel (``rgqa_tpu_torch/parallel/``), full width.  46:
   the train CLI under ``python -m torch.distributed.run --standalone
   --nproc_per_node 1`` (NCCL, world 1) against two one-process runs.
   47-48: two gloo ranks on cuda:0 (``tools/ddp_check.py``) against one
   process: RP, ``mixup_v1``, pretraining, the evaluate CLI with msp and
   maha, RP at dropout 0.1.  49: on the same two ranks the serve CLI, the
   distill CLI (cartography over two passes; two ensemble teachers) and
   the verifier (an epoch, then its evaluation), each held to one
   process with the launches per rank (the MC passes and the verifier
   also at dropout 0.1, on #4 / #5), and the serve under torchrun at
   world 1 on NCCL, byte for byte the one-process serve's lines.
50. the recipe pair through ``rgqa_tpu_torch.tools.recipes``:
   ``scripts/lxmert/train/vanilla.sh --synthetic --epochs 1`` then
   ``scripts/lxmert/test/msp.sh --synthetic`` from its ``LAST.pth``, full
   width on the card, each a process of its own: a ``LAST.pth`` that
   loads back whole and each RGQA testdev subset's result and dump.
51. long-stream dropout kernels (slice 24): 4L and 5L
   (``fused_attention_dropout_long_cuda`` / ``_bwd_cuda``, the dropout
   variants of #2 and #3L) against the plain pair at rate 0.1, f32 and
   bf16: UNITER's 76 x 76 (40-token questions + 36 RoIs, its padded-text
   mask) at batch 32 and 64; 165 x 165, 185 x 185, 65 x 185, 185 x 65 and
   277 x 277 at batch 256; 597 x 597 at batch 64 (pad-patch masks, one
   fully masked row); phase 3's bounds.  Rate 0 equals #2 / #3L bit for
   bit (output, row statistics, gradients); 4L with its row statistics
   gives the same output bits; ``<g, out> == <dv, v>`` within 2e-3 in
   f32; two runs at 165 give equal bits; the mask read out through a
   one-hot V (64 keys a call) equals ``dropout_keep_mask_ref`` bit for
   bit in each body (f32 whole-row at 76, key-tiled at 277, the bf16
   ``wgmma`` body at both), its kept fraction within 5 sigma.  Device
   times of 4L, 5L (both routes), #3L and SDPA with ``dropout_p=0.1``,
   the plain pair's CUDA-event times, beside the bound: bf16 at every
   shape, f32 at UNITER-76's batch 32 and ViLT's 165 at batch 256.
52. UNITER at 76 tokens (``max_text_len`` 40), full width: RP steps at
   dropout 0.1 through the kernels and the plain versions (12 4L and 12
   5L launches a step, none of #4 / #5; ms a step in turns), one step's
   loss (``LOSS_RTOL``) and gradients (relative L2 within
   ``UNITER_LONG_GRAD_RTOL``) against the plain path on the same seeds,
   and an MC-dropout batch of 256 (5 passes, 12 4L a pass, no 5L)
   against its plain re-score (``CONF_TOL``).
53. ``rgqa_tpu_torch.entry``: ``entry()`` (LXMERT 9/5/5 x 768, batch 8,
   bf16) through the kernels (34 #1) against its plain run;
   ``dryrun_multichip(2)`` and ``dryrun_multichip_fullshape(2)`` on two
   gloo ranks on cuda:0, started before phase 52 and run beside it, each
   with the JAX dry run's assertions, the tiny one's loss within
   ``DP_RTOL`` of one process's at the global batch of 4.
54. the f32 model paths (slice 26) through the long f32 bodies, full
   width under ``--fp32`` (f32 weights and products, no TF32): ViLT-B/32
   RP steps at 185 tokens (40-token text), batch 32 + RP, at dropout 0.1
   and 0 (12 #2 and 12 #3L a step at both: ViLT has no attention
   dropout), and UNITER-76 RP steps at dropout 0.1 (12 4L and 12 5L),
   each one step through the kernels and through the plain versions from
   one init and the same seeds: the loss within ``F32_LOSS_RTOL``, every
   gradient within ``F32_BAR`` (1e-4 + 1e-4 |plain|), ms a step in turns;
   a ViLT evaluation forward at batch 256 (12 #2), its logits within
   ``F32_BAR`` of the plain forward's.
55. the kernels' JSON line (times: the sum over the LXMERT shapes, and
   for #2 and #3L over 165x165 and 185x185, bf16, batch 256; for 4L / 5L
   one call at UNITER-76's batch 32; for the four experiment kernels the
   sum over their shapes and variants at batch 384), the nvidia-smi
   line, and last ``{"ok": true, "device": {...}}``.

The order: phases 1-3, 51 and 13 (without its entry points) run first,
alone on the card, since their times go into the kernels' line.  Then
three lanes run side by side, each phase of a lane after the one before
it: lane a in this process (4-12, 28-34, 52-54), lanes b (14-27, 35-36)
and c (13's entry points, 37-50) each in a child process of its own
(``chip_smoke.py --lane b|c``, in a session of its own, ended with what
it started when the run ends), whose output is printed as it ends.  Each
process keeps its own launch counts, so that a phase's reading sees only
its own launches.  Each phase's time line gives the most card memory its
process reserved.

Needs the repository beside it; it imports nothing of JAX.  It must end
within 1200 s on one H100, the kernels' build included.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import typing

E, HEADS = 768, 12
SHAPES = ((20, 20), (36, 36), (20, 36), (36, 20))  # (Sq, Skv) per LXMERT call kind
# UNITER's single stream: 20 text tokens + 36 RoI features, each
# question's text pads between its words and the image keys.
UNITER, UNITER_TEXT = (56, 56), 20
# CLIP ViT-B/32's vision stream at 224 px: 49 patches + CLS, no mask.
CLIP_SHAPE = (50, 50)
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
# The caption matcher's binary loss is the mean over 32 rows of ONE
# logit's BCE (~1): nothing averages a row's bf16 logit error (up to
# LOGIT_TOL, slope |sigmoid - target| <= 1) away but the 32 rows, so
# errors of either sign move it by ~LOGIT_TOL / sqrt(32) ~ 2e-2 relative;
# 2.0e-3 measured on the H100, the first step 6e-4.
CAPS_LOSS_RTOL = 1e-2
# Attention backward launches per training step: 34 forward calls, but the
# last cross layer's vision stream (its vis <- lang cross call and its
# vision self call) feeds nothing the loss reads (the answer head pools the
# language stream), so autograd runs no backward for those two.
BWD_PER_STEP = 32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM: device memory
BF16_FLOP_PER_S = 989e12  # H100 SXM: dense bf16 tensor cores
F32_FLOP_PER_S = 67e12  # H100 SXM: float32 outside the tensor cores (#1's f32 body)
KERNELS = {
    "fused_attention": ("rgqa_tpu_torch/csrc/fused_attention.cu", "rgqa_tpu/ops/attention.py:250"),
    "fused_attention_bwd": ("rgqa_tpu_torch/csrc/fused_attention_bwd.cu", "rgqa_tpu/ops/attention.py:448"),
    "fused_attention_dropout": ("rgqa_tpu_torch/csrc/fused_attention_dropout.cu", "rgqa_tpu/ops/attention.py:641"),
    "fused_attention_dropout_bwd": ("rgqa_tpu_torch/csrc/fused_attention_dropout.cu", "rgqa_tpu/ops/attention.py:691"),
    "fused_attention_long": ("rgqa_tpu_torch/csrc/fused_attention_long.cu", "rgqa_tpu/ops/attention.py:399"),
    # _fused_bwd_kernel at ViLT's streams (_fit_bwd_block's raised tiers).
    "fused_attention_long_bwd": ("rgqa_tpu_torch/csrc/fused_attention_long_bwd.cu", "rgqa_tpu/ops/attention.py:448"),
    # 4L / 5L: _fused_drop_kernel / _fused_drop_bwd_kernel beyond 64 tokens.
    "fused_attention_dropout_long": ("rgqa_tpu_torch/csrc/fused_attention_long.cu", "rgqa_tpu/ops/attention.py:641"),
    "fused_attention_dropout_long_bwd": ("rgqa_tpu_torch/csrc/fused_attention_long_bwd.cu",
                                         "rgqa_tpu/ops/attention.py:691"),
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
SCORER_ITERS = {"msp": 10, "energy": 10, "maha": 10, "odin": 5, "dropout": 3}
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
    _long_bwd_report(results["fused_attention_long_bwd"])
    _long_f32_report(results)
    _epilogue_report(results["epilogue"])
    _short_body_report(results)


WGMMA_KERNEL = re.compile(r"headfold_wgmmaILi(\d+)E")  # headfold_wgmma<kNP>, kNP keys in the window
# <kWG, kDrop>: kWG warpgroups a block; kDrop 1 is 4L, #2 with the dropout.
LONG_WGMMA_KERNEL = re.compile(r"fused_attention_long_wgmmaILi(\d+)ELb([01])E")
# <kDrop, kExact>: kDrop 1 is 5L; kExact 1 the route with D's sweep and dbias.
LONG_BWD_KERNEL = re.compile(r"long_bwd_(dq|dkv)_bf16ILb([01])ELb([01])E")
EPI_KERNEL = re.compile(r"epilogue_bf16ILi(\d+)E")  # epilogue_bf16<kNP>, kNP keys in a window
# The short bf16 bodies of #1 / #4 and #3 / #5: <kDrop, kNT>, kNT = SKP / 8.
SHORT_BODY = re.compile(r"(fused_attention_(?:fwd|bwd)_short_bf16)ILb([01])ELi(\d+)E")
# Their f32 bodies: <kDrop, kPerLane>, one softmax key a lane up to 32 keys.
SHORT_F32_BODY = re.compile(r"(fused_attention_(?:fwd|bwd)_short_f32)ILb([01])ELi(\d)E")


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


def _short_body_report(results) -> None:
    """Registers and spills of the short bf16 bodies' instances (#1 / #4
    forward, #3 / #5 backward; kNT 4 at 20 keys, 6 at 36, 8 at 37-64:
    UNITER's 56), from the build log; reported, not held."""
    parts = []
    for src in ("fused_attention", "fused_attention_bwd", "fused_attention_dropout"):
        if not results[src].log:
            parts.append(f"{src}.cu: reused build, no ptxas log")
            continue
        for fn, r in sorted(_ptxas_resources(results[src].log).items()):
            if m := SHORT_BODY.search(fn):
                parts.append(f"{src}.cu {m.group(1)}<drop {m.group(2)}, kNT {m.group(3)}>: "
                             f"{r['registers']} registers, spill {r['spill_stores']}/{r['spill_loads']} B "
                             "stores/loads")
    log("build", "short bf16 bodies (kNT 8 runs UNITER's 56 keys): " + "; ".join(parts))
    parts = []
    for src in ("fused_attention", "fused_attention_bwd", "fused_attention_dropout"):
        for fn, r in sorted(_ptxas_resources(results[src].log).items()):
            if m := SHORT_F32_BODY.search(fn):
                bwd, per_lane = "bwd" in m.group(1), int(m.group(3))
                sizes = (20,) if per_lane == 1 else (36, 50)
                smem = ", ".join(f"{s}x{s} {_short_f32_smem(s, s, E // HEADS, bwd)}" for s in sizes)
                parts.append(f"{src}.cu {m.group(1)}<drop {m.group(2)}, {per_lane} a lane>: {r['registers']} registers, "
                             f"spill {r['spill_stores']}/{r['spill_loads']} B stores/loads, "
                             f"{r['smem']} B static smem, dynamic B {smem}")
    log("build", "short f32 bodies: " + ("; ".join(parts) or "reused builds, no ptxas log"))


def _f32_ld(n: int) -> int:
    """``f32_ld`` of ``csrc/attention_common.cuh``: n rounded up to 4,
    plus 4 when that is an even number of 16-byte chunks."""
    r = (n + 3) // 4 * 4
    return r if (r // 4) % 2 else r + 4


def _short_f32_smem(sq: int, skv: int, d: int, backward: bool) -> int:
    """Dynamic shared memory of a short f32 body, as ``fwd_f32_layout`` /
    ``bwd_f32_layout`` lay it out (f32 words, the keep bits u32)."""
    ld, ldp, ngr = _f32_ld(d), _f32_ld(skv), (skv + 15) // 16
    small = (skv + 3) // 4 * 4 + (sq + 3) // 4 * 4 * backward + sq * ngr
    if backward:
        return 4 * (2 * sq * ld + skv * ld + max(skv * ld, sq * ldp) + sq * ldp + small)
    return 4 * (sq * max(ld, ldp) + 2 * skv * ld + small)


def _long_ring_smem(wg: int) -> int:
    """Dynamic shared memory of #2's and 4L's bf16 body with ``wg``
    warpgroups a block, as ``ring_smem_bytes`` in
    ``csrc/fused_attention_long.cu`` lays it out: ``wg`` Q tiles and 3
    ring stages each of K and V (64 x 64 bf16 a tile), 3 stages of 64 f32
    bias, and one 1024-byte swizzle period for the alignment (4L draws its
    keep words in registers)."""
    tile, stages = 64 * 64 * 2, 3
    return tile * (wg + 2 * stages) + 4 * 64 * stages + 1024


def _long_bwd_smem(pass_: str) -> int:
    """Dynamic shared memory of a bf16 pass of #3L / 5L, as
    ``dq_smem_bytes`` / ``dkv_smem_bytes`` in
    ``csrc/fused_attention_long_bwd.cu`` lay it out: two 64 x 64 bf16
    tiles (Q and g, or K and V) and 3 ring stages of two more (K and V, or
    Q and g), per stage 64 f32 of bias (dQ) or of statistics (m, log(sum))
    and D (dK/dV), and one 1024-byte swizzle period."""
    tile, stages = 64 * 64 * 2, 3
    return tile * (2 + 2 * stages) + stages * 4 * 64 * (1 if pass_ == "dq" else 3) + 1024


def _blocks_per_sm(res, symbol: str, n: int) -> list:
    """A built library's occupancy entry point ``symbol``: blocks an SM of
    its ``n`` bf16 instances (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    at their shared memory); raises on a CUDA error."""
    import ctypes

    out = (ctypes.c_int * n)()
    err = getattr(ctypes.CDLL(str(res.path)), symbol)(out)
    if err:
        raise AssertionError(f"{symbol} failed with CUDA error {err}")
    return list(out)


def _long_wgmma_report(res) -> None:
    """#2's and 4L's bf16 body (``fused_attention_long_wgmma<kWG, kDrop>``,
    one instance per warpgroups a block and dropout): registers, spills
    and static shared memory from the build log, the dynamic shared memory
    of its layout and blocks an SM, and HGMMA in its SASS; an instance
    without HGMMA fails the phase."""
    res_by_wg = {(int(m.group(1)), m.group(2) == "1"): r for fn, r in _ptxas_resources(res.log).items()
                 if (m := LONG_WGMMA_KERNEL.search(fn))}
    sass = _sass_hgmma(res.path)
    hgmma = None if sass is None else {(int(m.group(1)), m.group(2) == "1"): c for fn, c in sass.items()
                                       if (m := LONG_WGMMA_KERNEL.search(fn))}
    blocks = dict(zip(((1, False), (1, True), (2, False), (2, True)),
                      _blocks_per_sm(res, "rgqa_fused_attention_long_occupancy", 4)))
    parts = []
    for wg in sorted(set(res_by_wg) | set(hgmma or {})):
        part = (f"{wg[0]} warpgroups{', dropout (4L)' if wg[1] else ''}: "
                f"{_long_ring_smem(wg[0])} B dynamic smem, {blocks[wg]} blocks an SM")
        if wg in res_by_wg:
            r = res_by_wg[wg]
            part += (f", {r['registers']} registers, spill {r['spill_stores']}/{r['spill_loads']} B "
                     f"stores/loads, {r['smem']} B static smem")
        if hgmma is not None:
            part += f", {hgmma.get(wg, 0)} HGMMA in SASS"
        parts.append(part)
    log("build", "#2 / 4L bf16 body (fused_attention_long_wgmma<kWG, kDrop>, wgmma): " + "; ".join(parts)
        + ("" if res.log else "; reused build, no ptxas log to read")
        + ("" if hgmma is not None else "; cuobjdump not in the toolkit: SASS not read"))
    if hgmma is not None and (not hgmma or not all(hgmma.values())):
        raise AssertionError(f"#2's bf16 body has no HGMMA in some instance: {hgmma}")


def _long_bwd_report(res) -> None:
    """#3L's and 5L's bf16 passes (``long_bwd_{dq,dkv}_bf16<kDrop, kExact>``,
    kExact the route with D's sweep and dbias): registers, spills and
    static shared memory from the build log, their dynamic shared memory
    and blocks an SM, and HGMMA in their SASS; an instance without HGMMA
    fails the phase."""
    def key(m):
        return m.group(1), m.group(2) == "1", m.group(3) == "1"

    res_by = {key(m): r for fn, r in _ptxas_resources(res.log).items() if (m := LONG_BWD_KERNEL.search(fn))}
    sass = _sass_hgmma(res.path)
    hgmma = None if sass is None else {key(m): c for fn, c in sass.items() if (m := LONG_BWD_KERNEL.search(fn))}
    order = [(p, drop, exact) for p in ("dq", "dkv") for drop in (False, True) for exact in (False, True)]
    blocks = dict(zip(order, _blocks_per_sm(res, "rgqa_fused_attention_long_bwd_occupancy", 8)))
    parts = []
    for k in sorted(set(res_by) | set(hgmma or {})):
        part = (f"{k[0]} pass{' 5L' if k[1] else ' #3L'}, {'dbias' if k[2] else 'no dbias'}: "
                f"{_long_bwd_smem(k[0])} B dynamic smem, {blocks[k]} blocks an SM")
        if k in res_by:
            r = res_by[k]
            part += (f", {r['registers']} registers, spill {r['spill_stores']}/{r['spill_loads']} B "
                     f"stores/loads, {r['smem']} B static smem")
        if hgmma is not None:
            part += f", {hgmma.get(k, 0)} HGMMA in SASS"
        parts.append(part)
    log("build", "#3L / 5L bf16 passes (long_bwd_{dq,dkv}_bf16<kDrop, kExact>, wgmma): " + "; ".join(parts)
        + ("" if res.log else "; reused build, no ptxas log to read")
        + ("" if hgmma is not None else "; cuobjdump not in the toolkit: SASS not read"))
    if hgmma is not None and (len(hgmma) != 8 or not all(hgmma.values())):
        raise AssertionError(f"#3L / 5L's bf16 passes lack HGMMA in some instance: {hgmma}")


# The long f32 bodies: #2 / 4L fused_attention_long_f32<kDrop, kPerLane>
# and fused_attention_long_tiled_f32<kDrop>, #3L / 5L long_bwd_{dq,dkv}_f32
# <kDrop, kExact>.
LONG_F32_KERNEL = re.compile(r"(fused_attention_long_f32|fused_attention_long_tiled_f32|long_bwd_dq_f32|"
                             r"long_bwd_dkv_f32)I((?:L[bi]\d+E)+)")


def _long_f32_report(results) -> None:
    """Registers, spills and static shared memory of the long f32 bodies'
    instances from the build log, and blocks an SM from the sources'
    occupancy entry points at their dynamic shared memory (the forward's
    whole-row body at 76, 185 and 256 keys); reported, not held."""
    parts = []
    for src in ("fused_attention_long", "fused_attention_long_bwd"):
        for fn, r in sorted(_ptxas_resources(results[src].log).items()):
            if m := LONG_F32_KERNEL.search(fn):
                args = ", ".join(re.findall(r"L[bi](\d+)E", m.group(2)))
                parts.append(f"{m.group(1)}<{args}>: {r['registers']} registers, spill "
                             f"{r['spill_stores']}/{r['spill_loads']} B stores/loads")
    fwd = _blocks_per_sm(results["fused_attention_long"], "rgqa_fused_attention_long_f32_occupancy", 4)
    bwd = _blocks_per_sm(results["fused_attention_long_bwd"], "rgqa_fused_attention_long_bwd_f32_occupancy", 4)
    log("build", "long f32 bodies: " + ("; ".join(parts) or "reused builds, no ptxas log") + "; blocks an SM: "
        f"whole-row forward at 76 / 185 / 256 keys {fwd[0]} / {fwd[1]} / {fwd[2]}, key-tiled forward {fwd[3]}, "
        f"dQ pass {bwd[0]} (dbias {bwd[1]}), dK/dV pass {bwd[2]} (dbias {bwd[3]})")


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
    output gradient, and a (B, Skv) -10000 mask with one fully masked row
    (a quarter of the keys masked at random; at UNITER's shape its mask,
    ``_uniter_bias``)."""
    import torch

    dev = "cuda"
    if sq == skv:
        q, k, v = torch.randn(b, sq, 3 * E, generator=gen, device=dev).to(dtype).split(E, -1)
    else:
        q = torch.randn(b, sq, E, generator=gen, device=dev).to(dtype)
        k, v = torch.randn(b, skv, 2 * E, generator=gen, device=dev).to(dtype).split(E, -1)
    g = torch.randn(b, sq, E, generator=gen, device=dev).to(dtype)
    if (sq, skv) == UNITER:
        return q, k, v, g, _uniter_bias(b, gen)
    mask = (torch.rand(b, skv, generator=gen, device=dev) > 0.25).float()
    mask[:, 0] = 1.0
    mask[b // 2] = 0.0  # a fully masked row stays finite
    return q, k, v, g, (1.0 - mask) * -10000.0


def _uniter_bias(b, gen, text: int = UNITER_TEXT):
    """UNITER's (B, text + 36) -10000 mask: questions of 4-``text`` tokens
    (20: the 56-token stream; 40: the 76-token one), the pads after each
    masked in the middle of the keys, the 36 image keys kept; row b // 2
    fully masked."""
    import torch

    lengths = torch.randint(4, text + 1, (b,), generator=gen, device="cuda")
    bias = torch.zeros(b, text + 36, device="cuda")
    bias[:, :text][torch.arange(text, device="cuda")[None, :] >= lengths[:, None]] = -10000.0
    bias[b // 2] = -10000.0
    return bias


def _bound_ms(name: str, b: int, sq: int, skv: int, itemsize: int) -> tuple[float, str]:
    """The least time the card needs for one call: each input read once,
    each output written once, over the memory rate, against the products'
    flops over the peak rate of their type (bf16 tensor cores; f32
    outside them)."""
    d = E // HEADS
    act = b * (2 * sq + 2 * skv) * E * itemsize  # q, k, v, out (forward)
    mask = b * skv * 4
    if name.endswith("bwd"):
        nbytes = b * (3 * sq + 4 * skv) * E * itemsize + 2 * mask  # + g, dq, dk, dv; bias, dbias
        flops = 10 * b * HEADS * sq * skv * d  # S, dP, dV, dQ, dK
    else:
        nbytes = act + mask
        flops = 4 * b * HEADS * sq * skv * d  # S, PV
    return _bound(nbytes, flops, F32_FLOP_PER_S if itemsize == 4 else BF16_FLOP_PER_S)


def _bound(nbytes: int, flops: int, flop_rate: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    """The larger of moving ``nbytes`` at the memory rate and doing
    ``flops`` at ``flop_rate`` (default the bf16 tensor-core rate), in ms,
    and which it is."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
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


def _mask_readout(att, gen, s: int = 36):
    """#4's mask at ``s`` x ``s``, read through q = k = 0 (uniform P) and a
    one-hot V: out[b, i, h*D + j] = keep(b, h, i, j) * scale / Skv."""
    import torch

    b, d = 256, E // HEADS
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
    log("kernels", f"fused_attention_dropout mask (B=256, {s}x{s}, seed {seed}) equals "
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
            for sq, skv in SHAPES + (UNITER,):
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
                what = " (UNITER's mask)" if (sq, skv) == UNITER else ""
                msg = (f"{dname} B={b} {sq}x{skv}{what}: max|kernel-plain| " + "; ".join(msgs)
                       + "; rate 0 == #1/#3")
                if (sq, skv) in ((36, 36), UNITER):
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
    _mask_readout(att, gen, UNITER[1])  # 56 keys: 16-key groups past the last key
    _f32_lxmert_kernel(att, gen, times)
    _clip_kernel(att, gen, errs, times)
    _long_kernel(att, gen, errs, times)
    return errs, times


def _us(us) -> str:
    return "not measured (the profiler lost events)" if us is None else f"{us:.1f} us"


def _f32_lxmert_kernel(att, gen, times):
    """#1 / #3 / #4 / #5's f32 bodies at LXMERT's four shapes under
    LXMERT's mask, batch 256 (the match scorer's pretraining model and any
    ``--fp32`` answerer run #1, 34 a forward; ``--fp32`` training #3, #4
    and #5): the CUDA-event times the loop above took (kernel and plain in
    turns, the library call once) and the profiler's device time of each
    kernel and of its f32 SDPA call (#3 / #5: forward and backward less
    forward), beside the bound (bytes at the memory rate or the products
    at the f32 rate)."""
    import torch
    from rgqa_tpu_torch.tools.time_attention import device_us

    for sq, skv in SHAPES:
        q, k, v, g, bias = _attention_inputs(256, sq, skv, torch.float32, gen)
        seed = int(torch.randint(0, 2**62, (), generator=gen, device="cuda"))
        lib = _sdpa_calls(q, k, v, g, bias)
        kernels = {
            "fused_attention": (lambda: att.fused_attention_cuda(q, k, v, bias, HEADS), "fwd", None),
            "fused_attention_bwd": (lambda: att.fused_attention_bwd_cuda(q, k, v, bias, g, HEADS),
                                    "fwd_bwd", "fwd"),
            "fused_attention_dropout": (lambda: att.fused_attention_dropout_cuda(q, k, v, bias, HEADS, RATE, seed),
                                        "drop", None),
            "fused_attention_dropout_bwd": (
                lambda: att.fused_attention_dropout_bwd_cuda(q, k, v, bias, g, HEADS, RATE, seed),
                "drop_fwd_bwd", "drop"),
        }
        lib_dev = {name: device_us(fn, 50, match=None) for name, fn in lib.items()}
        parts = []
        for name, (kernel, lib_all, lib_less) in kernels.items():
            kernel_ms, plain_ms, lib_ms, bound = times[(name, "float32", sq, skv)]
            sdpa = lib_dev[lib_all]
            if lib_less:
                sdpa = None if sdpa is None or lib_dev[lib_less] is None else sdpa - lib_dev[lib_less]
            by = _bound_ms(name, 256, sq, skv, 4)[1]
            parts.append(f"{name.replace('fused_attention', '#')} events us kernel/plain/sdpa "
                         f"{kernel_ms * 1e3:.1f}/{plain_ms * 1e3:.1f}/{lib_ms * 1e3:.1f}, bound "
                         f"{bound * 1e3:.1f} ({by}), device time kernel {_us(device_us(kernel, 50))}, "
                         f"sdpa {_us(sdpa)}")
        log("kernels", f"float32 B=256 {sq}x{skv} (LXMERT's mask; the f32 bodies): " + "; ".join(parts))
        del q, k, v, g, bias, lib
    torch.cuda.empty_cache()


def _clip_kernel(att, gen, errs, times):
    """#1 and #3 at CLIP's 50x50 with no mask (the zero (B, 50) bias the
    vision tower's ``bias=None`` becomes), f32 and bf16, q, k, v column
    views of one fused QKV product, held to the plain versions: #1 at
    batch 256, 32 and 7, #3 (the CLIP tower's backward under
    ``--update_weight_model``, slice 19) at batch 256 and 32.  At batch
    256 and 32 each is timed beside the unmasked SDPA call (#3: forward +
    backward less forward) and the bound, CUDA events (kernel and plain
    in turns) and the profiler's device time."""
    import torch
    import torch.nn.functional as F
    from rgqa_tpu_torch.tools.time_attention import device_us

    sq, skv = CLIP_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for b in (256, 32, 7):
            q, k, v = torch.randn(b, sq, 3 * E, generator=gen, device="cuda").to(dtype).split(E, -1)
            g = torch.randn(b, sq, E, generator=gen, device="cuda").to(dtype)
            bias = att.bias_vector(None, b, skv, device="cuda")
            calls = {"fused_attention": (lambda: att.fused_attention_cuda(q, k, v, bias, HEADS),
                                         lambda: att.attention_natural_ref(q, k, v, bias, HEADS))}
            if b != 7:
                calls["fused_attention_bwd"] = (lambda: att.fused_attention_bwd_cuda(q, k, v, bias, g, HEADS),
                                                lambda: att.attention_bwd_ref(q, k, v, bias, g, HEADS))
            msgs = []
            for name, (kernel, plain) in calls.items():
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                msgs.append(_compare(name, dtype, got, want, errs))
            msg = f"{dname} B={b} 50x50 (CLIP's vision tower, no mask): max|kernel-plain| " + "; ".join(msgs)
            if b in (256, 32):
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]

                def heads(t):
                    return t.view(b, skv, HEADS, E // HEADS).transpose(1, 2)

                def sdpa(grad=False):
                    with torch.set_grad_enabled(grad):
                        return F.scaled_dot_product_attention(*(heads(t) for t in leaves))

                library = {"fused_attention": sdpa,
                           "fused_attention_bwd": lambda: torch.autograd.grad(sdpa(True), leaves, heads(g))}
                parts = []
                for name, (kernel, plain) in calls.items():
                    plain_ms, kernel_ms = in_turns(plain, kernel)
                    lib_ms = cuda_ms(library[name]) - (cuda_ms(sdpa) if name.endswith("bwd") else 0.0)
                    bound, by = _bound_ms(name, b, sq, skv, q.element_size())
                    key = (name, dname, sq, skv) if b == 256 else (name, dname, sq, skv, b)
                    times[key] = (kernel_ms, plain_ms, lib_ms, bound)
                    dev_k = device_us(kernel, 50)
                    dev_lib = device_us(library[name], 50, match=None)
                    if name.endswith("bwd") and dev_lib is not None:
                        fwd_dev = device_us(sdpa, 50, match=None)
                        dev_lib = None if fwd_dev is None else dev_lib - fwd_dev
                    parts.append(f"{name.replace('fused_attention', '#')} us kernel/plain/library/bound " + "/".join(
                        f"{x * 1e3:.1f}" for x in times[key]) + f" ({by}); device time kernel {_us(dev_k)}, "
                        f"sdpa {_us(dev_lib)}")
                msg += "; " + "; ".join(parts)
                del leaves
            log("kernels", msg)
            del q, k, v, g, bias
    torch.cuda.empty_cache()


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
    of 256 keys and beyond (277 and 597 tokens), #3L on both routes (with
    dbias, and without: D from #2's output); #2 with its row statistics
    gives the same output bits, and in f32 their log-sum-exp is the plain
    scores'; #3L's two runs bit for bit; times at LONG_TIMED, f32 and bf16
    (#3L without dbias, as ViLT's training step runs it; in f32 10 calls a
    timing, the plain versions' hundreds of launches a call the most of
    it)."""
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
                # The route every model path runs: D from the output, no dbias.
                no_dbias = lambda: att.fused_attention_long_bwd_cuda(  # noqa: E731
                    q, k, v, bias, g, HEADS, lse, dbias=False, out=out)
                msgs = []
                for name, (kernel, plain) in calls.items():
                    got, want = kernel(), plain()
                    torch.cuda.synchronize()
                    msgs.append(_compare(name, dtype, got, want, errs))
                    if name == "fused_attention_long" and not torch.equal(got, out):
                        raise AssertionError(f"#2 with row statistics differs at {dname} B={b} {sq}x{skv}")
                if not all(torch.equal(a, c) for a, c in zip(got, calls["fused_attention_long_bwd"][0]())):
                    raise AssertionError(f"two runs of #3L differ at {dname} B={b} {sq}x{skv}")
                got = no_dbias()
                if got[3] is not None or not all(torch.equal(a, c) for a, c in zip(got[:3], no_dbias()[:3])):
                    raise AssertionError(f"#3L without dbias returned dbias or differs twice at {dname} B={b} "
                                         f"{sq}x{skv}")
                msgs.append("without dbias " + _compare("fused_attention_long_bwd", dtype, got[:3], want[:3], errs))
                msg = (f"{dname} B={b} {sq}x{skv}: max|kernel-plain| " + "; ".join(msgs)
                       + "; #2 with statistics: equal bits; #3L twice (both routes): equal bits")
                if dtype == torch.float32:
                    msg += "; " + _lse_check(q, k, bias, lse)
                if b > 7 and (sq, skv) in LONG_TIMED:
                    kw = {} if dtype == torch.bfloat16 else {"iters": 10}
                    lib = _sdpa_calls(q, k, v, g, bias)
                    library = {"fused_attention_long": cuda_ms(lib["fwd"], **kw)}
                    library["fused_attention_long_bwd"] = (
                        cuda_ms(lib["fwd_bwd"], **kw) - library["fused_attention_long"])
                    timed = ["fused_attention_long", "fused_attention_long_bwd"]
                    for name in timed:  # #3L on the model's route
                        kernel = no_dbias if name == "fused_attention_long_bwd" else calls[name][0]
                        plain_ms, kernel_ms = in_turns(calls[name][1], kernel, **kw)
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


def phase_model(backbone: str = "lxmert", per_forward: int = 34, phase: str = "model"):
    """The full-width forward at batch 256, bf16, with padded questions:
    ``per_forward`` launches of #1, logits held to the plain version, the
    text mask's effect, kernels and plain timed in turns."""
    import numpy as np
    import torch
    from rgqa_tpu_torch.data.batching import to_device
    from rgqa_tpu_torch.models.zoo import build_model, default_config, example_batch
    from rgqa_tpu_torch.ops import attention as att

    cfg = default_config(backbone)
    enc = cfg.encoder
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model, forward = build_model(cfg, use_bf16=True, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    depth = (f"{enc.l_layers}/{enc.r_layers}/{enc.x_layers}" if backbone == "lxmert"
             else f"{enc.num_layers} ({cfg.max_text_len} + {enc.num_objects} tokens)")
    log(phase, f"{type(model).__name__} {depth} layers x "
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
        log(phase, f"text lengths {int(padded['input_mask'].sum(1).min())}-"
            f"{padded['input_mask'].shape[1]}; kernel launches per forward = "
            f"{launches} (want {per_forward}); max|logits kernel-plain| = {err:.3e} (bound "
            f"{LOGIT_TOL:.0e}, max|logit| {lp.abs().max().item():.3f}); the text "
            f"mask moves the logits by {effect:.3e} (want > {2 * LOGIT_TOL:.0e})")
        if launches != per_forward:
            raise AssertionError(f"{launches} kernel launches per forward, want {per_forward}")
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
    log(phase, f"forward at batch 256 bf16: kernel {kernel_ms:.3f} ms ({qps_k:.1f} q/s), "
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
    the u8 wire with padded rects; the caption matcher: pairs, segment 1
    from the question on, a third of the rows unanswerable)."""
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
        if cfg.backbone == "caps":
            batch.update(_caps_pairs(batch, rng), id_mask=(np.arange(b) % 3 != 0).astype(np.float32))
        out.append(to_device(batch, "cuda"))
    return out


def _caps_pairs(batch: dict, rng) -> dict:
    """Segment ids of ``[CLS] caption [SEP] question [SEP]`` pairs over a
    padded batch: 1 from a caption of 3-7 pieces on, to the last real
    token."""
    import numpy as np

    mask = batch["input_mask"]
    cap = rng.integers(3, 8, mask.shape[0])
    seg = (np.arange(mask.shape[1])[None, :] >= cap[:, None] + 2) & (mask == 1)
    return {"segment_ids": seg.astype(np.int32)}


def _train_model(dropout: float, backbone: str, patch: int | None = None, text: int | None = None,
                 fp32: bool = False):
    """A full-width model for training steps: f32 master weights and bf16
    compute (``fp32``: f32 compute, as ``--fp32``); ``text`` the question
    length where not the backbone's (ViLT's default: the train CLI's)."""
    import torch
    from rgqa_tpu_torch.models.zoo import build_model, default_config

    cfg = default_config(backbone)
    if backbone == "vilt" and text is None:
        text = VILT_TRAIN_TEXT
    if text is not None:
        cfg = dataclasses.replace(cfg, max_text_len=text)
    if backbone == "caps":
        cfg = dataclasses.replace(cfg, num_answers=1)  # the match logit
    if patch is not None:
        cfg = dataclasses.replace(cfg, vilt_patch_size=patch)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, hidden_dropout=dropout, attention_dropout=dropout))
    model, forward = build_model(
        cfg, use_bf16=not fp32, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0), train=True,
    )
    return cfg, model, forward


def _run_steps(model, forward, init, batches, use_fused, steps=None, binary=False):
    """Steps from ``init`` with a fresh BertAdam, RP pairs or (``binary``,
    the caption strategy) the binary loss; (losses, ms per step of the
    steps after the first ``len(batches)``)."""
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
    step = make_train_step(forward, opt, sample_pair=not binary, binary=binary, rng=rng,
                           use_fused=use_fused)
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


def _step_launches(backbone: str, dropout: float, long: bool = False) -> dict:
    """Kernel launches per training step: LXMERT's 34 forward and
    ``BWD_PER_STEP`` backward attention calls, UNITER's 12 and 12, through
    the dropout pair when dropout is on (``long``: a stream past 64
    tokens, #2 / #3L or 4L / 5L); ViLT's 12 and 12 through #2 and #3L (no
    attention dropout)."""
    want = {name: 0 for name in KERNELS}
    if backbone == "vilt":
        want.update({"fused_attention_long": 12, "fused_attention_long_bwd": 12})
    elif backbone in ("uniter", "caps"):
        # Every layer's keys feed the pooled CLS: 12 backward calls too.
        pair = ("fused_attention", "fused_attention_bwd") if dropout == 0.0 else (
            "fused_attention_dropout", "fused_attention_dropout_bwd")
        if long:
            pair = tuple(name.replace("_bwd", "_long_bwd") if name.endswith("_bwd") else f"{name}_long"
                         for name in pair)
        want.update(dict.fromkeys(pair, 12))
    elif dropout == 0.0:
        want.update({"fused_attention": 34, "fused_attention_bwd": BWD_PER_STEP})
    else:
        want.update({"fused_attention_dropout": 34, "fused_attention_dropout_bwd": BWD_PER_STEP})
    return want


def phase_train_steps(backbone: str = "lxmert", patch: int | None = None,
                      dropouts=(0.0, RATE), n: int = 4, timed: int = 10, phase: str | None = None,
                      text: int | None = None):
    """``n`` steps from one init through the kernels and through the plain
    versions at each dropout rate; ``timed`` more steps of each, in turns.
    ``patch``: ViLT's patch size (16: the 597-token stream); ``text``:
    the question length, where not the backbone's default (UNITER at
    40: the 76-token stream)."""
    import torch

    phase = phase or ("train" if backbone == "lxmert" else f"{backbone}-train")
    binary = backbone == "caps"  # the caption strategy: no RP, the binary loss
    rows = 32 if binary else 64  # batch 32 plus its 32 RP pairs
    loss_rtol = CAPS_LOSS_RTOL if binary else LOSS_RTOL
    result = {}
    for dropout in dropouts:
        cfg, model, forward = _train_model(dropout, backbone, patch, text)
        batches = _train_batches(cfg, n)
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        reset_counts()
        k_losses, _ = _run_steps(model, forward, init, batches, None, binary=binary)
        counts = read_counts()
        p_losses, _ = _run_steps(model, forward, init, batches, False, binary=binary)
        if read_counts() != counts:
            raise AssertionError("the plain steps launched a kernel")
        per_step = {name: c / n for name, c in counts.items()}
        want = _step_launches(backbone, dropout, long=text is not None and text + 36 > 64)
        rel = [abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses)]
        if not all(math.isfinite(x) for x in k_losses + p_losses):
            raise AssertionError(f"non-finite losses {k_losses} {p_losses}")
        # Time in turns: plain, kernels, kernels, plain.
        t = [_run_steps(model, forward, init, batches, fused, n + timed, binary=binary)[1]
             for fused in (False, None, None, False)]
        plain_ms, kernel_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        log(phase, f"dropout {dropout}: batch 32{'' if binary else ' + RP'} ({rows} rows), {n} steps from one init: "
            f"launches per step {per_step}; losses kernels {[round(x, 4) for x in k_losses]}, "
            f"plain {[round(x, 4) for x in p_losses]}, max relative gap {max(rel):.3e}"
            + (f" (bound {loss_rtol:.0e})" if dropout == 0.0 else " (same masks: the same seeds and bytes)"))
        log(phase, f"dropout {dropout}: ms per step (mean of {timed} after {n} warm-up, in turns) "
            f"kernels {kernel_ms:.3f} ({rows * 1e3 / kernel_ms:.1f} rows/s), plain {plain_ms:.3f} "
            f"({rows * 1e3 / plain_ms:.1f} rows/s)")
        if per_step != want:
            raise AssertionError(f"launches per step {per_step}, want {want}")
        if dropout == 0.0 and not max(rel) <= loss_rtol:
            raise AssertionError(f"dropout-off losses of the kernels and the plain versions differ by {max(rel)}")
        result[dropout] = (counts, kernel_ms, plain_ms)
        del model, forward, batches, init
        torch.cuda.empty_cache()
    return result


def phase_train_path(keep: str):
    """The train CLI and an evaluate of its ``BEST.pth`` (phase 9); the
    root and ``BEST.pth`` are copied into ``keep`` for phases 29-30."""
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
        shutil.copytree(root, os.path.join(keep, "gqa"))
        shutil.copy(os.path.join(out_dir, "BEST.pth"), os.path.join(keep, "BEST.pth"))
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
    """Phase 13 in this process, before the lanes (its entry points:
    :func:`_run_experiments`, in lane c)."""
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

    _held_shapes(att, gen, errs)


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


def _favoured_pth(path: str, root: str, seed: int, favour: bool, backbone: str = "lxmert") -> str:
    """A seeded full-width model as a reference ``.pth``; ``favour``
    raises the answer bias of testdev's most frequent answer, so the
    random model answers some questions right (``--target_acc`` needs a
    reachable accuracy)."""
    import collections

    import torch
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.models.zoo import build_model, default_config
    from rgqa_tpu_torch.train.state import save_reference_pth

    ds = GQADataset(root, "testdev", add_uq=True)
    cfg = dataclasses.replace(default_config(backbone), num_answers=ds.num_answers - 1)
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


def _scorer_runs(phase, runs, root, maha_root, tmp) -> None:
    """Each (name, scorer kind of SCORE_TOL, flags, launches) of ``runs``
    through the evaluate CLI at batch 256, its outputs and launches
    checked and re-scored through the plain versions; the Mahalanobis
    run's cached rerun (``maha-cached``) must give its JSON bit for bit."""
    import torch
    from rgqa_tpu_torch.cli import evaluate

    fitted = None
    for name, kind, extra, launches in runs:
        out_dir = os.path.join(tmp, "out_" + name.removesuffix("-cached"))
        data = maha_root if "maha" in name else root
        argv = ["--synthetic", "--data_root", data, *extra, "--test", "testdev",
                "--batchSize", "256", "--output", out_dir]
        reset_counts()
        t0 = time.perf_counter()
        results = evaluate.main(argv)["testdev"]
        torch.cuda.synchronize()
        rows = _check_scored_outputs(phase, out_dir, data, results, argv,
                                     time.perf_counter() - t0, read_counts(), launches)
        if name.endswith("maha"):
            if not os.path.isfile(os.path.join(out_dir, "sample_estimates.pkl")):
                raise AssertionError("--scorer maha wrote no sample_estimates.pkl")
            fitted = rows
        if name.endswith("maha-cached") and rows != fitted:
            raise AssertionError("--scorer maha with the cached estimator changed the predictions")
        _plain_rescore(phase, argv, data, rows, kind)
    torch.cuda.empty_cache()


def phase_scorer_cli() -> None:
    """The evaluate CLI with each new scorer flag at full width, batch
    256, each run held to a plain re-score (phase 15)."""
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
        _scorer_runs("scorer-cli", runs, root, maha_root, tmp)


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


# ---------------------------------------------------------------------------
# Phases 18-22: UNITER (slice 14).
# ---------------------------------------------------------------------------

UNITER_PER_FORWARD = 12  # one self-attention a layer over the whole stream


def phase_uniter_scorers() -> None:
    """The evaluate CLI with UNITER's scorers at full width, batch 256,
    each held to a plain re-score (as phase 15)."""
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa

    per, s = UNITER_PER_FORWARD, len(SEED_LIST)
    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_uniter_scorers_") as tmp:
        root, maha_root = os.path.join(tmp, "gqa"), os.path.join(tmp, "gqa_maha")
        make_synthetic_gqa(root)
        make_synthetic_gqa(maha_root, SyntheticSpec(**MAHA_ROOT))
        a = _favoured_pth(os.path.join(tmp, "a.pth"), root, 1, favour=True, backbone="uniter")
        b = _favoured_pth(os.path.join(tmp, "b.pth"), root, 2, favour=False, backbone="uniter")
        n = math.ceil(len(GQADataset(root, "testdev", add_uq=True)) / 256)
        n_maha = math.ceil(len(GQADataset(maha_root, "testdev", add_uq=True)) / 256)
        fits = math.ceil(len(GQADataset(maha_root, "train", add_uq=True)) / 256)

        def want(**counts):
            return {**{k: 0 for k in KERNELS}, **counts}

        # ODIN and noised Mahalanobis: a forward with the input gradient
        # (every layer's backward: the RoI inputs reach every layer) and
        # the scoring forward.
        grad_maha = dict(fused_attention=2 * per * n_maha, fused_attention_bwd=per * n_maha)
        uniter = ["--backbone", "uniter"]
        maha = [*uniter, "--scorer", "maha", "--noise", str(MAHA_NOISE), "--load", a]
        runs = [
            ("uniter-energy", "energy", [*uniter, "--scorer", "energy", "--load", a],
             want(fused_attention=per * n)),
            ("uniter-odin", "odin", [*uniter, "--scorer", "odin", "--temperature", str(ODIN_T), "--noise",
                                     str(ODIN_NOISE), "--load", a],
             want(fused_attention=2 * per * n, fused_attention_bwd=per * n)),
            ("uniter-dropout", "dropout", [*uniter, "--scorer", "dropout", "--seed_list",
                                           ",".join(map(str, SEED_LIST)), "--load", a],
             want(fused_attention_dropout=per * s * n)),
            ("uniter-maha", None, maha, want(**dict(grad_maha, fused_attention=per * fits + 2 * per * n_maha))),
            ("uniter-maha-cached", None, maha, want(**grad_maha)),
            ("uniter-ensemble", "ensemble", [*uniter, "--load", f"{a},{b}"], want(fused_attention=2 * per * n)),
        ]
        _scorer_runs("uniter-scorers", runs, root, maha_root, tmp)


def phase_uniter_train_path() -> None:
    """The UNITER train CLI at full width (RP, dropout 0.1, batch 32): its
    launches, GQA-UNITER checkpoints and an evaluate of its ``BEST.pth``."""
    import torch
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.cli import train as train_cli
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.data.dataset import GQADataset

    phase, per = "uniter-train", UNITER_PER_FORWARD
    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_uniter_train_") as tmp:
        root, out_dir = os.path.join(tmp, "gqa"), os.path.join(tmp, "snap")
        argv = ["--backbone", "uniter", "--synthetic", "--data_root", root, "--sample_pair",
                "--epochs", "1", "--batchSize", "32", "--output", out_dir]
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
        want.update({"fused_attention_dropout": per * steps, "fused_attention_dropout_bwd": per * steps,
                     "fused_attention": per * valid_forwards})
        if launches != want:
            raise AssertionError(f"launches {launches}, want {want} ({steps} steps, "
                                 f"{valid_forwards} validation forwards)")
        if not all(math.isfinite(x) for x in history["loss"]):
            raise AssertionError(f"non-finite training loss {history['loss']}")
        for name in ("BEST.pth", "LAST.pth", "LAST.state.pt"):
            if not os.path.isfile(os.path.join(out_dir, name)):
                raise AssertionError(f"the UNITER train CLI wrote no {name}")
        for name in ("BEST.pth", "LAST.pth"):
            keys = torch.load(os.path.join(out_dir, name), map_location="cpu", weights_only=True)
            if "encoder.model.uniter.encoder.layer.11.attention.self.query.weight" not in keys or not all(
                    k.startswith(("encoder.model.uniter.", "logit_fc.")) for k in keys):
                raise AssertionError(f"{name} is not in the GQA-UNITER key format: {sorted(keys)[:4]}")
        log(phase, f"BEST.pth and LAST.pth in the GQA-UNITER key format ({len(keys)} tensors, "
            "encoder.model.uniter.* + logit_fc.*)")

        eval_dir = os.path.join(tmp, "eval")
        eargv = ["--backbone", "uniter", "--synthetic", "--data_root", root, "--test", "testdev",
                 "--load", os.path.join(out_dir, "BEST.pth"), "--output", eval_dir]
        reset_counts()
        t0 = time.perf_counter()
        results = evaluate.main(eargv)["testdev"]
        counts = read_counts()
        _check_eval_outputs(phase, eval_dir, root, results, eargv, time.perf_counter() - t0,
                            counts["fused_attention"])
        if any(n for name, n in counts.items() if name != "fused_attention"):
            raise AssertionError(f"the UNITER evaluate path launched another kernel than #1: {counts}")
        torch.cuda.empty_cache()


def phase_uniter_serve() -> None:
    """One serve wave through UNITER at full width (phase 17's stream,
    msp, batch 256)."""
    import torch
    from rgqa_tpu_torch.cli.serve import serve_lines
    from rgqa_tpu_torch.data.synthetic import make_synthetic_gqa

    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_uniter_serve_") as tmp:
        root = os.path.join(tmp, "gqa")
        make_synthetic_gqa(root)
        lines, good = _serve_stream(root)
        argv = ["--backbone", "uniter", "--synthetic", "--data_root", root, "--test", "testdev",
                "--scorer", "msp", "--batchSize", "256", "--wave_timeout", "0", "--serve_stats",
                "--output", os.path.join(tmp, "serve")]
        reset_counts()
        t0 = time.perf_counter()
        out, stats, _ = serve_lines(argv, lines)
        torch.cuda.synchronize()
        launches = read_counts()
        _served("serve uniter", lines, out, stats, good)
        want = {**{k: 0 for k in KERNELS}, "fused_attention": UNITER_PER_FORWARD * math.ceil(len(good) / 256)}
        log("uniter-serve", f"msp ({' '.join(argv)}) in {time.perf_counter() - t0:.2f} s: {len(out)} lines, "
            f"{len(good)} answered; launches {({k: v for k, v in launches.items() if v})}; latency {stats}")
        if launches != want:
            raise AssertionError(f"serve uniter: launches {launches}, want {want}")
        torch.cuda.empty_cache()


def phase_uniter_profile() -> None:
    """``tools.profile_forward`` for UNITER: the forward at batch 256 and a
    training step (32 + RP), kernels and plain; the attention share and
    the idle share (1 - device time over wall) of each."""
    from rgqa_tpu_torch.tools import profile_forward

    for unit, argv in (("forward", ["--batch", "256", "--iters", "10", "--repeats", "2"]),
                       ("step", ["--train", "--iters", "5", "--repeats", "2"])):
        for run in profile_forward.main(["--backbone", "uniter", *argv]):
            attention = sum(c["ms"] for cls, c in run["classes"].items() if cls.startswith("attention"))
            log("uniter-profile", f"batch {run['batch']} {run['route']}: device {run['device_ms']:.3f} ms "
                f"per {unit}, wall {run['wall_ms']:.3f} ms; attention share "
                f"{attention / run['device_ms']:.4f}, idle share {1 - run['busy_share']:.4f}")


def phase_uniter() -> int:
    """Phases 18-22; returns the evaluate path's launches of #1."""
    phase_model("uniter", UNITER_PER_FORWARD, phase="uniter-model")
    launches = phase_main_path("uniter", ("--backbone", "uniter", "--batchSize", "256"), "fused_attention",
                               UNITER_PER_FORWARD)
    phase_uniter_scorers()
    phase_train_steps("uniter", timed=6)
    phase_uniter_train_path()
    phase_uniter_serve()
    phase_uniter_profile()
    return launches


# ---------------------------------------------------------------------------
# Phases 23-27: BUTD and the caption matcher.
# ---------------------------------------------------------------------------

CAPS_PER_FORWARD = 12  # one self-attention a layer over the 20-token pair
# BUTD on the card against the same weights on the CPU, both f32 without
# TF32: the order of the sums and cuDNN's gate arithmetic differ, and the
# GRU carries the difference through its 40 steps: 1.2e-5 on logits of
# up to 0.1, 1.7e-5 on the pooled feature, 3.0e-6 on the confidences at
# batch 256 on the H100 (weights of unit-norm rows, _spread_butd).  The
# bounds leave a tenfold margin.
BUTD_MIN_AGREEMENT = 0.99
BUTD_LOGIT_TOL = 1e-4
BUTD_CONF_TOL = 3e-5
# (atol, rtol) of a BUTD scorer's scores, card against CPU: the logit
# bound through each scorer's slope (sigmoid <= 1/4, softplus <= 1 on two
# logits, ODIN's sigmoid(l / T) 1 / (4 T), plus phase 15's sign-flip term).
BUTD_SCORE_TOL = {
    "msp": (BUTD_CONF_TOL, 0.0), "branched": (BUTD_CONF_TOL, 0.0), "ensemble": (BUTD_CONF_TOL, 0.0),
    "energy": (2 * BUTD_LOGIT_TOL, 0.0), "odin": (LOGIT_TOL / (2 * ODIN_T), 0.0),
}


def _no_launches(phase: str, what: str) -> None:
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"{phase}: {what} launched an attention kernel: {counts}")


def _spread_butd(ref: dict) -> dict:
    """A GQA-BUTD state_dict with each weight-normed layer's gain ``g``
    times sqrt(its output width): rows of unit norm.  At BUTD's init
    (``g`` = 1, the whole matrix of unit norm) a random or briefly
    trained model's logits are ~1e-4, its confidences 0.5 to 4 dp, and
    no check would see a difference."""
    return {k: (v * math.sqrt(ref[k[: -len("g")] + "v"].shape[0]) if k.endswith("weight_g") else v)
            for k, v in ref.items()}


def _front_padded(batch: dict, pad: int, seed: int) -> dict:
    """BUTD's questions front-padded to 40 tokens, 3-20 words each."""
    import numpy as np

    ids = batch["token_ids"].copy()
    lengths = np.random.default_rng(seed).integers(3, 21, ids.shape[0])
    ids[np.arange(ids.shape[1])[None, :] < ids.shape[1] - lengths[:, None]] = pad
    return dict(batch, token_ids=ids)


def phase_butd_model() -> None:
    """BUTD's forward at full width, batch 256, on the card against the
    same weights on the CPU (phase 23)."""
    import torch
    from rgqa_tpu_torch.data.batching import to_device
    from rgqa_tpu_torch.models.zoo import build_model, default_config, example_batch

    phase = "butd-model"
    cfg = default_config("butd")
    t0 = time.perf_counter()
    model, forward = build_model(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():  # unit-norm rows (see _spread_butd)
        for mod in model.modules():
            if hasattr(mod, "g") and hasattr(mod, "v"):
                mod.g.fill_(math.sqrt(mod.v.shape[0]))
    cpu_model, cpu_forward = build_model(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    n_params = sum(p.numel() for p in model.parameters())
    log(phase, f"ButdForGQA: GRU {cfg.butd_hidden_dim} over 40 tokens, embeddings {cfg.butd_embed_dim} x "
        f"{cfg.butd_vocab_size + 1}, {cfg.encoder.num_objects} RoIs x {cfg.encoder.visual_feat_dim} + 4, "
        f"{cfg.num_answers} answers; {n_params} params in f32, built in {time.perf_counter() - t0:.2f} s")
    batch = _front_padded(example_batch(cfg, 256, seed=0), cfg.butd_vocab_size, 1)
    card = to_device(batch, "cuda")
    reset_counts()
    tf32 = torch.backends.cudnn.allow_tf32
    with torch.inference_mode():
        out = forward(card)
        torch.cuda.synchronize()
        # PyTorch's default lets cuDNN's GRU round to TF32: the model turns
        # it off for itself, so the same call gives the same bits.
        torch.backends.cudnn.allow_tf32 = True
        try:
            again = forward(card)
            torch.cuda.synchronize()
            reset_flag = torch.backends.cudnn.allow_tf32
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        ms = cuda_ms(lambda: forward(card), iters=20, warmup=3)
        _no_launches(phase, "the forward")
        ref = cpu_forward(to_device(batch, "cpu"))
    logits, want = out["logits"].float().cpu(), ref["logits"]
    if logits.shape != (256, cfg.num_answers) or not torch.isfinite(logits).all():
        raise AssertionError(f"{phase}: logits {tuple(logits.shape)} not finite / wrong shape")
    dlogit = (logits - want).abs().max().item()
    dpooled = (out["pooled"].cpu() - ref["pooled"]).abs().max().item()
    agree = (logits.argmax(-1) == want.argmax(-1)).float().mean().item()
    dconf = (torch.sigmoid(logits).amax(-1) - torch.sigmoid(want).amax(-1)).abs().max().item()
    same = torch.equal(again["logits"], out["logits"])
    log(phase, f"card vs CPU (f32, same weights): labels agree on {agree:.4f} (want >= {BUTD_MIN_AGREEMENT}), "
        f"max|logits diff| {dlogit:.3e} (bound {BUTD_LOGIT_TOL:.0e}, max|logit| "
        f"{want.abs().max().item():.3f}), max|pooled diff| {dpooled:.3e}, max|confidence diff| {dconf:.3e} "
        f"(bound {BUTD_CONF_TOL:.0e}); with cuDNN's TF32 on the call gives the same bits: {same}, "
        f"the switch restored: {reset_flag}; {ms:.3f} ms per forward ({256e3 / ms:.1f} q/s); "
        "no attention kernel launched")
    if not (agree >= BUTD_MIN_AGREEMENT and dlogit <= BUTD_LOGIT_TOL and dconf <= BUTD_CONF_TOL):
        raise AssertionError(f"{phase}: the card disagrees with the CPU")
    if not same or not reset_flag:
        raise AssertionError(f"{phase}: the forward's products follow the global TF32 switch")
    del model, forward, card, out, again
    torch.cuda.empty_cache()


def phase_butd_train(tmp: str, root: str) -> str:
    """The BUTD train CLI (RP, batch 32): its ``BEST.pth`` in GQA-BUTD's
    key format, loaded back whole (phase 24).  Returns its path."""
    import torch
    from rgqa_tpu_torch.checkpoint.convert import load_reference_pth
    from rgqa_tpu_torch.cli import train as train_cli
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.runner import GQARunner

    phase = "butd-train"
    out_dir = os.path.join(tmp, "butd_snap")
    argv = ["--backbone", "butd", "--synthetic", "--data_root", root, "--sample_pair", "--epochs", "1",
            "--batchSize", "32", "--output", out_dir]
    reset_counts()
    t0 = time.perf_counter()
    history = train_cli.main(argv)
    torch.cuda.synchronize()
    log(phase, f"train CLI ({' '.join(argv)}) in {time.perf_counter() - t0:.2f} s: history {history}")
    _no_launches(phase, "the train CLI")
    if not all(math.isfinite(x) for x in history["loss"]):
        raise AssertionError(f"{phase}: non-finite training loss {history['loss']}")
    best = os.path.join(out_dir, "BEST.pth")
    for name in ("BEST.pth", "LAST.pth", "LAST.state.pt"):
        if not os.path.isfile(os.path.join(out_dir, name)):
            raise AssertionError(f"{phase}: the BUTD train CLI wrote no {name}")
    ref = torch.load(best, map_location="cpu", weights_only=True)
    if ("w_emb.emb.weight" not in ref or ref["q_enc.rnn.weight_hh_l0"].shape != (3072, 1024)
            or ref["ans_classifier.3.weight_g"].shape != ()):
        raise AssertionError(f"{phase}: BEST.pth is not in GQA-BUTD's key format: {sorted(ref)[:4]}")
    sd, missing, unused = load_reference_pth(best, backbone="butd")
    cfg, _ = parse_cli([*argv, "--load", best])
    loaded = GQARunner(cfg, init_train=False).model.state_dict()
    if missing or unused or loaded.keys() != sd.keys() or any(
            not torch.equal(loaded[k].cpu(), v) for k, v in sd.items()):
        raise AssertionError(f"{phase}: BEST.pth loads back with missing {missing}, unused {unused}, "
                             "or into other weights")
    log(phase, f"BEST.pth in GQA-BUTD's key format ({len(ref)} tensors: w_emb.emb.weight "
        f"{tuple(ref['w_emb.emb.weight'].shape)}, q_enc.rnn.*_l0, weight_g 0-d / weight_v / bias), "
        "loads back with no key missing or unused")
    return best


def _cpu_rescore(phase, argv, root, rows, kind) -> None:
    """Re-score the split as the CLI run ``argv`` did (its options, its
    weights, the same ``sample_estimates.pkl``) on the CPU; hold the
    answers to ``BUTD_MIN_AGREEMENT`` (ODIN's to ``MIN_LABEL_AGREEMENT``:
    where an input gradient is round-off, its sign, and with it the
    perturbed input, differs between the two devices, and a near tie can
    change its answer; 1 of 64 did on the H100) and, unless ``kind`` is
    None, the confidences to ``BUTD_SCORE_TOL[kind]`` plus the 4 dp step."""
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.data.dataset import GQADataset

    cfg, _, plan = evaluate.parse_args(argv)
    runner = evaluate.make_runner(cfg, "cpu", plan["scorer"])
    encoded = runner._encode(GQADataset(root, "testdev", add_uq=True))
    if plan["scorer"] == "ensemble":
        path = os.path.join(cfg.output, "cpu_predict.json")
        runner.ensemble_ood_evaluate(encoded, plan["ensemble"], dump=path)
        with open(path) as f:
            plain = {p["questionId"]: (p["prediction"], p["confidence"]) for p in json.load(f)}
    else:
        plain = runner.score_split(encoded)
    if sorted(plain) != sorted(rows):
        raise AssertionError(f"{phase}: the CPU re-score scored other questions")
    agree = sum(rows[q][0] == a for q, (a, _) in plain.items()) / len(plain)
    dconf = max(abs(rows[q][1] - c) for q, (_, c) in plain.items())
    if kind is None:
        excess, bound = -math.inf, "answers held"
    else:
        atol, rtol = BUTD_SCORE_TOL[kind]
        atol += 1e-4  # the prediction JSON's 4 dp
        excess = max(abs(rows[q][1] - c) - atol - rtol * abs(c) for q, (_, c) in plain.items())
        bound = f"bound {atol:.1e} + {rtol:.0e} |cpu|; worst excess {excess:.3e}"
    min_agree = MIN_LABEL_AGREEMENT if kind == "odin" else BUTD_MIN_AGREEMENT
    log(phase, f"vs the CPU: answers agree on {agree:.4f} (want >= {min_agree}), "
        f"max|confidence diff| {dconf:.3e} ({bound})")
    if agree < min_agree or excess > 0:
        raise AssertionError(f"{phase}: the card's answers disagree with the CPU's")


def phase_butd_scorers(tmp: str, root: str, best: str) -> None:
    """The BUTD evaluate CLI with each scorer, batch 256, and a serve wave
    (phase 25)."""
    import torch
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.cli.serve import serve_lines
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.runner import GQARunner

    phase = "butd-scorers"
    butd = ["--backbone", "butd", "--synthetic", "--data_root", root, "--test", "testdev", "--batchSize", "256"]
    cfg, _ = parse_cli([*butd, "--branched", "--seed", "2", "--output", os.path.join(tmp, "butd_branched")])
    branched = GQARunner(cfg, init_train=False).save("branched")
    last = best.replace("BEST.pth", "LAST.pth")
    for path in (best, last, branched):  # unit-norm rows: confidences apart from 0.5
        spread = path.replace(".pth", "_spread.pth")
        torch.save(_spread_butd(torch.load(path, map_location="cpu", weights_only=True)), spread)
    best, last, branched = (p.replace(".pth", "_spread.pth") for p in (best, last, branched))
    zero = {k: 0 for k in KERNELS}
    runs = [
        ("msp", "msp", ["--scorer", "msp", "--load", best]),
        ("energy", "energy", ["--scorer", "energy", "--load", best]),
        ("odin", "odin", ["--scorer", "odin", "--temperature", str(ODIN_T), "--noise", str(ODIN_NOISE),
                          "--load", best]),
        ("maha", None, ["--scorer", "maha", "--load", best]),
        ("maha-cached", None, ["--scorer", "maha", "--load", best]),
        ("dropout", None, ["--scorer", "dropout", "--seed_list", ",".join(map(str, SEED_LIST)), "--load", best]),
        ("dropout-again", None, ["--scorer", "dropout", "--seed_list", ",".join(map(str, SEED_LIST)),
                                 "--load", best]),
        ("branched", "branched", ["--branched", "--scorer", "branched", "--load", branched]),
        ("ensemble", "ensemble", ["--load", f"{best},{last}"]),
    ]
    scored = {}
    for name, kind, extra in runs:
        out_dir = os.path.join(tmp, "butd_out_" + name.split("-")[0])
        argv = [*butd, *extra, "--output", out_dir]
        reset_counts()
        t0 = time.perf_counter()
        results = evaluate.main(argv)["testdev"]
        torch.cuda.synchronize()
        rows = _check_scored_outputs(phase, out_dir, root, results, argv, time.perf_counter() - t0,
                                     read_counts(), zero)
        if name.endswith(("-cached", "-again")):
            if rows != scored[name.split("-")[0]]:
                raise AssertionError(f"{phase}: {name} changed the predictions")
            log(phase, f"{name}: the same prediction JSON as the first run")
            continue
        scored[name] = rows
        if name != "dropout":
            _cpu_rescore(phase, argv, root, rows, kind)
    if all(scored["dropout"][q][1] == c for q, (_, c) in scored["msp"].items()):
        raise AssertionError(f"{phase}: MC-dropout scored as msp: the dropout did not run")

    lines, good = _serve_stream(root)
    argv = [*butd, "--scorer", "msp", "--load", best, "--wave_timeout", "0", "--serve_stats",
            "--output", os.path.join(tmp, "butd_serve")]
    reset_counts()
    t0 = time.perf_counter()
    out, stats, _ = serve_lines(argv, lines)
    torch.cuda.synchronize()
    answers = _served("serve butd", lines, out, stats, good)
    _no_launches(phase, "serve")
    # Record s<i> asks testdev's question i mod the split's length.
    with open(os.path.join(root, "testdev.json")) as f:
        qids = [r["question_id"] for r in json.load(f)]
    msp = {f"s{i:06d}": scored["msp"][qids[i % len(qids)]] for i in range(SERVE_RECORDS)}
    pairs = [(a, msp[a["questionId"]]) for a in answers if a["questionId"] in msp]
    agree = sum(a["prediction"] == p for a, (p, _) in pairs)
    dconf = max(abs(a["confidence"] - c) for a, (_, c) in pairs)
    n = len(pairs)
    log(phase, f"serve msp ({' '.join(argv)}) in {time.perf_counter() - t0:.2f} s: {len(out)} lines, "
        f"{len(good)} answered; latency {stats}; vs the evaluate CLI's msp: answers agree on {agree} of "
        f"{n}, max|confidence diff| {dconf:.3e} (bound {BUTD_CONF_TOL:.0e} + 1e-4, the 4 dp step)")
    if agree < BUTD_MIN_AGREEMENT * n or not dconf <= BUTD_CONF_TOL + 1e-4:
        raise AssertionError(f"{phase}: serve answers otherwise than the evaluate CLI")
    torch.cuda.empty_cache()


def phase_caps_path(tmp: str, root: str, butd_best: str) -> None:
    """The caption-strategy train CLI on the train split and its UQ
    pairs (a third of the rows unanswerable, so the matcher's confidences
    spread), then ``--scorer caption`` gating the BUTD answerer,
    re-scored through the plain versions (phase 27)."""
    import torch
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.cli import train as train_cli
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.runner import GQARunner

    phase, per = "caps", CAPS_PER_FORWARD
    out_dir = os.path.join(tmp, "caps_snap")
    argv = ["--backbone", "caps", "--strategy", "caption", "--synthetic", "--data_root", root,
            "--train", "train,train_uq", "--epochs", "1", "--batchSize", "32", "--output", out_dir]
    reset_counts()
    t0 = time.perf_counter()
    history = train_cli.main(argv)
    torch.cuda.synchronize()
    launches = read_counts()
    cfg, _ = parse_cli(argv)
    steps = len(GQADataset(root, cfg.data.train_splits)) // 32
    valid = math.ceil(len(GQADataset(root, cfg.data.valid_splits)) / 32)
    log(phase, f"train CLI ({' '.join(argv)}) in {time.perf_counter() - t0:.2f} s: history {history}; "
        f"launches {({k: v for k, v in launches.items() if v})}")
    want = {**{k: 0 for k in KERNELS}, "fused_attention_dropout": per * steps,
            "fused_attention_dropout_bwd": per * steps, "fused_attention": per * valid}
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, want {want} ({steps} steps, {valid} "
                             "validation forwards)")
    if not all(math.isfinite(x) for x in history["loss"]):
        raise AssertionError(f"{phase}: non-finite training loss {history['loss']}")
    last = os.path.join(out_dir, "LAST.pth")
    keys = torch.load(last, map_location="cpu", weights_only=True)
    if ("encoder.encoder.layer.11.attention.self.query.weight" not in keys
            or keys["logit_fc.3.weight"].shape != (1, 1536)
            or not all(k.startswith(("encoder.", "logit_fc.")) for k in keys)):
        raise AssertionError(f"{phase}: LAST.pth is not a trained GQABERT: {sorted(keys)[:4]}")
    log(phase, f"LAST.pth a trained GQABERT ({len(keys)} tensors, encoder.* + logit_fc.*, one match logit)")

    eval_dir = os.path.join(tmp, "caps_eval")
    eargv = ["--backbone", "caps", "--scorer", "caption", "--load", last, "--load_gqa", butd_best,
             "--ans_backbone", "butd", "--synthetic", "--data_root", root, "--test", "testdev",
             "--batchSize", "256", "--output", eval_dir]
    forwards = math.ceil(len(GQADataset(root, "testdev", add_uq=True)) / 256)
    reset_counts()
    t0 = time.perf_counter()
    results = evaluate.main(eargv)["testdev"]
    torch.cuda.synchronize()
    rows = _check_scored_outputs(phase, eval_dir, root, results, eargv, time.perf_counter() - t0, read_counts(),
                                 {**{k: 0 for k in KERNELS}, "fused_attention": per * forwards})
    # The same matcher and answerer with every attention call through the
    # plain version.
    before = read_counts()
    ecfg, device, plan = evaluate.parse_args(eargv)
    runner = evaluate.make_runner(ecfg, device, plan["scorer"])
    fused = runner.forward
    runner.forward = lambda batch, **kw: fused(batch, use_fused=False, **kw)
    answerer = GQARunner(ecfg.replace(load=ecfg.load_gqa, model=plan["answerer_model"],
                                      train=dataclasses.replace(ecfg.train, strategy="conf"),
                                      output=os.path.join(tmp, "caps_plain_answerer")),
                         init_train=False, device=device)
    path = os.path.join(tmp, "caps_plain.json")
    runner.gated_ood_evaluate(runner._encode(GQADataset(root, "testdev", add_uq=True)), answerer, dump=path)
    torch.cuda.synchronize()
    if read_counts() != before:
        raise AssertionError(f"{phase}: the plain re-score launched a kernel")
    with open(path) as f:
        plain = {p["questionId"]: (p["prediction"], p["confidence"]) for p in json.load(f)}
    same = all(rows[q][0] == a for q, (a, _) in plain.items()) and sorted(plain) == sorted(rows)
    dconf = max(abs(rows[q][1] - c) for q, (_, c) in plain.items())
    confs = sorted(c for _, c in rows.values())
    log(phase, f"vs plain attention: the BUTD answerer's answers equal: {same}; match confidences "
        f"{confs[0]:.4f}-{confs[-1]:.4f} ({len(set(confs))} distinct), max|diff| {dconf:.3e} (bound "
        f"{CONF_TOL:.0e} + 1e-4, the 4 dp step); {per} launches of #1 per matcher forward x {forwards}")
    if not same or not dconf <= CONF_TOL + 1e-4:
        raise AssertionError(f"{phase}: the caption scorer disagrees with the plain re-score")
    if len(set(confs)) < 2:
        raise AssertionError(f"{phase}: every match confidence is {confs[0]}: the re-score would see nothing")
    del runner, answerer, fused
    torch.cuda.empty_cache()


def phase_butd_caps() -> None:
    """Phases 23-27."""
    from rgqa_tpu_torch.data.synthetic import make_synthetic_gqa

    phase_butd_model()
    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_butd_") as tmp:
        root = os.path.join(tmp, "gqa")
        make_synthetic_gqa(root)
        best = phase_butd_train(tmp, root)
        phase_butd_scorers(tmp, root, best)
        phase_train_steps("caps", timed=6)
        phase_caps_path(tmp, root, best)


# ---------------------------------------------------------------------------
# Phases 28-31: CLIP and the LXMERT match scorer.
# ---------------------------------------------------------------------------

CLIP_PER_FORWARD = 12  # one vision self-attention a layer; the text tower's are plain
MATCH_PER_FORWARD = 34  # the pretraining encoder's, as the answerer's
# CLIP in f32 without TF32, the card against the same weights on the CPU
# and kernel #1 against its plain version: both sides are exact f32 sums
# in other orders (#1's f32 body holds 2e-5 of the plain attention at
# O(1) inputs; 12 pre-norm layers carry that as relative error), and
# the embeddings are L2-normalized, so a cosine moves by about the
# features' relative error (1e-6 to 1e-5).  The bound leaves a tenfold
# margin and more.
CLIP_COS_TOL = 1e-4
# The match confidence softmax(matched)[:, 1] in f32 (slope <= 1/4 in
# the logit gap): the same argument, through 34 attention calls.
MATCH_CONF_TOL = 1e-4


def _hf_clip_dir(path: str, seed: int) -> str:
    """A full-width ViT-B/32 HF CLIP checkpoint directory from a seeded
    init: ``pytorch_model.bin`` (with HF's ``position_ids`` buffers),
    ``config.json`` and a byte-level BPE vocabulary (the byte alphabet
    and a few merges; EOT its highest id, as in CLIP's, so the original
    configs' argmax pooling finds it)."""
    import torch
    from rgqa_tpu_torch.data.clip_tokenizer import bytes_to_unicode
    from rgqa_tpu_torch.models.clip import ClipConfig, ClipModel, init_clip_weights

    cfg = ClipConfig()
    with torch.device("cuda"):
        model = ClipModel(cfg)
    init_clip_weights(model, torch.Generator(device="cuda").manual_seed(seed))
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    sd["vision_model.embeddings.position_ids"] = torch.arange(cfg.num_patches + 1)[None]
    sd["text_model.embeddings.position_ids"] = torch.arange(cfg.max_text_len)[None]
    os.makedirs(path, exist_ok=True)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"projection_dim": 512, "logit_scale_init_value": 2.6592,
                   "text_config": {"hidden_size": 512, "num_hidden_layers": 12, "num_attention_heads": 8,
                                   "intermediate_size": 2048, "vocab_size": 49408,
                                   "max_position_embeddings": 77, "eos_token_id": 2},
                   "vision_config": {"hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
                                     "intermediate_size": 3072, "image_size": 224, "patch_size": 32}}, f)
    b2u = bytes_to_unicode()
    merges = [("t", "h"), ("th", "e</w>"), ("i", "s</w>"), ("w", "h"), ("wh", "a"), ("wha", "t</w>")]
    tokens = list(b2u.values()) + [t + "</w>" for t in b2u.values()] + [a + b for a, b in merges]
    tokens += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(dict.fromkeys(tokens))}, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    del model
    return path


def phase_clip_model() -> None:
    """CLIP ViT-B/32 at full width, f32, batch 256 (phase 28): 12
    launches of #1 an image forward at 50x50 and none in the text tower;
    the cosine, image and text features held to the plain version on the
    card and to the same weights on the CPU; TF32 switched on around the
    call changes no bit (the model holds it off); timed."""
    import torch
    from rgqa_tpu_torch.models.clip import ClipConfig, ClipModel, example_inputs, init_clip_weights
    from rgqa_tpu_torch.ops.pixels import clip_normalize
    from rgqa_tpu_torch.tools import profile_forward

    phase = "clip-model"
    cfg = ClipConfig()
    t0 = time.perf_counter()
    with torch.device("cuda"):
        model = ClipModel(cfg)
    init_clip_weights(model, torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    cpu = ClipModel(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(phase, f"ClipModel ViT-B/32: vision 12 x 768 over {cfg.num_patches} + 1 tokens at {cfg.image_size} px, "
        f"text 12 x 512 over {cfg.max_text_len} tokens, projection {cfg.projection_dim}; {n_params} params "
        f"in f32, built in {time.perf_counter() - t0:.2f} s")
    ids, mask, u8 = example_inputs(cfg, 256, seed=0)
    card = [torch.from_numpy(a).cuda() for a in (ids, mask, u8)]
    with torch.inference_mode():
        reset_counts()
        img = model.image_features(clip_normalize(card[2]))
        torch.cuda.synchronize()
        per_image = read_counts()
        txt = model.text_features(card[0], card[1])
        torch.cuda.synchronize()
        text_launches = sum(read_counts().values()) - sum(per_image.values())
        cos = model.cosine(*card[:2], clip_normalize(card[2]))
        before = read_counts()
        cos_plain = model.cosine(*card[:2], clip_normalize(card[2]), use_fused=False)
        torch.cuda.synchronize()
        if read_counts() != before:
            raise AssertionError(f"{phase}: the plain forward launched a kernel")
        with profile_forward._tf32():  # TF32 allowed in cuBLAS and cuDNN around the call
            cos_tf32 = model.cosine(*card[:2], clip_normalize(card[2]))
            torch.cuda.synchronize()
        plain_ms, kernel_ms = in_turns(
            lambda: model.cosine(*card[:2], clip_normalize(card[2]), use_fused=False),
            lambda: model.cosine(*card[:2], clip_normalize(card[2])), iters=10, warmup=2)
        t0 = time.perf_counter()
        cpu_u8 = torch.from_numpy(u8)
        cpu_img = cpu.image_features(clip_normalize(cpu_u8))
        cpu_txt = cpu.text_features(torch.from_numpy(ids), torch.from_numpy(mask))
        cpu_cos = cpu.cosine(torch.from_numpy(ids), torch.from_numpy(mask), clip_normalize(cpu_u8))
        cpu_s = time.perf_counter() - t0
    want = {**{k: 0 for k in KERNELS}, "fused_attention": CLIP_PER_FORWARD}
    if per_image != want or text_launches:
        raise AssertionError(f"{phase}: launches per image forward {per_image}, want {want}; "
                             f"text tower {text_launches}, want 0")
    cos, cos_plain, cos_tf32 = (c.float().cpu() for c in (cos, cos_plain, cos_tf32))
    if cos.shape != (256,) or not torch.isfinite(cos).all():
        raise AssertionError(f"{phase}: cosines {tuple(cos.shape)} not finite / wrong shape")

    def rel(a, b):
        return ((a.float().cpu() - b).norm() / b.norm()).item()

    d_plain = (cos - cos_plain).abs().max().item()
    d_cpu = (cos - cpu_cos).abs().max().item()
    log(phase, f"12 launches of #1 an image forward at 50x50, none in the text tower: {per_image['fused_attention']}"
        f"/{text_launches}; cosines {cos.min().item():.4f}..{cos.max().item():.4f}; kernel vs plain "
        f"max|cos diff| {d_plain:.3e}; card vs CPU (f32, TF32 off, same weights): max|cos diff| {d_cpu:.3e} "
        f"(bound {CLIP_COS_TOL:.0e} each), image features relative error {rel(img, cpu_img):.3e}, text "
        f"{rel(txt, cpu_txt):.3e}; with TF32 allowed the call gives the same bits: "
        f"{torch.equal(cos, cos_tf32)}; CPU forward {cpu_s:.2f} s")
    if not (d_plain <= CLIP_COS_TOL and d_cpu <= CLIP_COS_TOL):
        raise AssertionError(f"{phase}: the cosines disagree")
    if not torch.equal(cos, cos_tf32):
        raise AssertionError(f"{phase}: the f32 model's products follow the global TF32 switches")
    log(phase, f"scorer forward (normalize, both towers, cosine) at batch 256, f32: kernel {kernel_ms:.3f} ms "
        f"({256e3 / kernel_ms:.1f} pairs/s), plain attention {plain_ms:.3f} ms ({256e3 / plain_ms:.1f} pairs/s)")
    del model, cpu, card, img, txt
    torch.cuda.empty_cache()


def _scorer_cli(phase, argv, root, per_batch) -> tuple[dict, int]:
    """An evaluate CLI run (f32, batch 256) with ``per_batch`` launches of
    #1 a batch of 256 besides the answerer's 34; its outputs checked.
    Returns ``{qid: (answer, confidence)}`` and the launches of #1."""
    import torch
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.data.dataset import GQADataset

    out_dir = argv[argv.index("--output") + 1]
    batches = math.ceil(len(GQADataset(root, "testdev", add_uq=True)) / 256)
    reset_counts()
    t0 = time.perf_counter()
    results = evaluate.main(argv)["testdev"]
    torch.cuda.synchronize()
    want = {**{k: 0 for k in KERNELS}, "fused_attention": (34 + per_batch) * batches}
    launches = read_counts()
    rows = _check_scored_outputs(phase, out_dir, root, results, argv, time.perf_counter() - t0, launches, want)
    confs = sorted(c for _, c in rows.values())
    if len(set(confs)) < 2:
        raise AssertionError(f"{phase}: every confidence is {confs[0]}: the re-score would see nothing")
    return rows, launches["fused_attention"]


def _held_to_plain(phase, rows, plain_path, bound) -> None:
    with open(plain_path) as f:
        plain = {p["questionId"]: (p["prediction"], p["confidence"]) for p in json.load(f)}
    same = sorted(plain) == sorted(rows) and all(rows[q][0] == a for q, (a, _) in plain.items())
    dconf = max(abs(rows[q][1] - c) for q, (_, c) in plain.items())
    confs = sorted(c for _, c in rows.values())
    log(phase, f"vs the plain versions: answers equal: {same}; confidences {confs[0]:.4f}..{confs[-1]:.4f} "
        f"({len(set(confs))} distinct), max|diff| {dconf:.3e} (bound {bound:.0e} + 1e-4, the 4 dp step)")
    if not same or not dconf <= bound + 1e-4:
        raise AssertionError(f"{phase}: the scorer disagrees with the plain re-score")


def phase_clip_cli(tmp: str, root: str, best: str, clip_dir: str | None = None, phase: str = "clip-cli") -> int:
    """``--scorer clip`` through the evaluate CLI (phase 29): the train
    CLI's LXMERT answerer (``--fp32``), a full-width random HF CLIP
    checkpoint (or ``clip_dir``), the synthetic root's CLIP pack (written
    by the run), batch 256; 12 launches of #1 a CLIP forward beside the
    answerer's 34; re-scored with every attention call through the plain
    versions.  Returns the run's launches of #1."""
    import torch
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.scorers.clip import ClipScorer

    clip_dir = clip_dir or _hf_clip_dir(os.path.join(tmp, "clip-vit-b32"), seed=1)
    argv = ["--synthetic", "--data_root", root, "--test", "testdev", "--fp32", "--load", best,
            "--scorer", "clip", "--clip_path", clip_dir, "--batchSize", "256",
            "--output", os.path.join(tmp, f"{phase}_eval")]
    rows, launches = _scorer_cli(phase, argv, root, CLIP_PER_FORWARD)
    if not os.path.isfile(os.path.join(root, "pixels_clip_224", "meta.json")):
        raise AssertionError(f"{phase}: the run wrote no CLIP pack")
    before = read_counts()
    cfg, device, plan = evaluate.parse_args(argv)
    runner = evaluate.make_runner(cfg, device, plan["scorer"])
    fused = runner.forward
    runner.forward = lambda batch, **kw: fused(batch, use_fused=False, **kw)
    scorer = ClipScorer(clip_dir, batch_size=256, device=device, use_fused=False)
    path = os.path.join(tmp, f"{phase}_plain.json")
    runner.clip_ood_evaluate(runner._encode(GQADataset(root, "testdev", add_uq=True)), scorer.scores,
                             os.path.join(root, "images"), dump=path, batch_size=256)
    torch.cuda.synchronize()
    if read_counts() != before:
        raise AssertionError(f"{phase}: the plain re-score launched a kernel")
    _held_to_plain(phase, rows, path, CLIP_COS_TOL)
    del runner, scorer
    torch.cuda.empty_cache()
    return launches


def phase_match_cli(tmp: str, root: str, best: str) -> int:
    """``--scorer match`` through the evaluate CLI (phase 30): a random
    full-width ``model_LXRT.pth`` in the reference layout (loaded back
    with no key missing or unused), the train CLI's answerer
    (``--fp32``), batch 256; 34 launches of #1 a match forward beside the
    answerer's 34, f32; re-scored through the plain versions.  Returns
    the run's launches of #1."""
    import torch
    from rgqa_tpu_torch.checkpoint.convert import load_reference_pth, to_reference_state_dict
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.models.lxmert import LxmertPretraining
    from rgqa_tpu_torch.models.zoo import default_config, init_weights, load_pretraining

    phase = "match-cli"
    enc = default_config().encoder
    with torch.device("cuda"):
        model = LxmertPretraining(enc)
    init_weights(model, torch.Generator(device="cuda").manual_seed(5))
    with torch.no_grad():  # a random matched head of std 0.02 gives confidences ~0.5 to 4 dp
        model.cls.seq_relationship.weight.mul_(10.0)
    pth = os.path.join(tmp, "model_LXRT.pth")
    torch.save(to_reference_state_dict(model.state_dict(), backbone="lxmert_pretrain"), pth)
    n_params = sum(p.numel() for p in model.parameters())
    del model
    _, missing, unused = load_reference_pth(pth, backbone="lxmert_pretrain")
    log(phase, f"model_LXRT.pth: LXMERT 9/5/5 x 768 with the MLM, matched, visual and 9500-answer QA heads, "
        f"{n_params} params ({os.path.getsize(pth) / 1e6:.1f} MB); loaded back: {len(missing)} keys missing, "
        f"{len(unused)} unused")
    if missing or unused:
        raise AssertionError(f"{phase}: missing {missing[:3]}, unused {unused[:3]}")
    argv = ["--synthetic", "--data_root", root, "--test", "testdev", "--fp32", "--load", best,
            "--scorer", "match", "--loadLXMERT", pth, "--batchSize", "256",
            "--output", os.path.join(tmp, "match_eval")]
    rows, launches = _scorer_cli(phase, argv, root, MATCH_PER_FORWARD)
    before = read_counts()
    cfg, device, plan = evaluate.parse_args(argv)
    runner = evaluate.make_runner(cfg, device, plan["scorer"])
    fused = runner.forward
    runner.forward = lambda batch, **kw: fused(batch, use_fused=False, **kw)
    _, pretrain = load_pretraining(pth, runner.model_cfg.encoder, device=device)
    path = os.path.join(tmp, "match_plain.json")
    runner.match_ood_evaluate(runner._encode(GQADataset(root, "testdev", add_uq=True)),
                              lambda batch, **kw: pretrain(batch, use_fused=False, **kw), dump=path)
    torch.cuda.synchronize()
    if read_counts() != before:
        raise AssertionError(f"{phase}: the plain re-score launched a kernel")
    _held_to_plain(phase, rows, path, MATCH_CONF_TOL)
    del runner, pretrain
    torch.cuda.empty_cache()
    return launches


def phase_clip_profile() -> None:
    """``tools.profile_forward --backbone clip`` (phase 31): the CLIP
    scorer forward at batch 256, kernels and plain; device time by kernel
    class, #1's share and the idle share (batch 32 since slice 19 only in
    ``profile_forward``'s own default run)."""
    from rgqa_tpu_torch.tools import profile_forward

    for run in profile_forward.main(["--backbone", "clip", "--batch", "256", "--iters", "5",
                                     "--repeats", "2"]):
        attention = sum(c["ms"] for cls, c in run["classes"].items() if cls.startswith("attention"))
        log("clip-profile", f"batch {run['batch']} {run['route']}: device {run['device_ms']:.3f} ms per forward, "
            f"wall {run['wall_ms']:.3f} ms; #1 share {attention / run['device_ms']:.4f}, idle share "
            f"{1 - run['busy_share']:.4f}; {run['attention_launches']} attention launches")


def phase_clip_match(keep: str) -> None:
    """Phases 28-31, each timed."""
    root, best = os.path.join(keep, "gqa"), os.path.join(keep, "BEST.pth")
    timed("28 clip model", phase_clip_model)
    timed("29 clip CLI", phase_clip_cli, keep, root, best)
    timed("30 match CLI", phase_match_cli, keep, root, best)
    timed("31 clip profile", phase_clip_profile)


# ---------------------------------------------------------------------------
# Phases 32-34: the single-loader strategies and the coverage scorer.
# ---------------------------------------------------------------------------


# Phase 32's steps: each strategy's step flags, its model's options, and
# whether the UQ answer is a class (targets keep their UQ column).  The
# energy margins are scripts/lxmert/train/energy.sh's.
STRATEGY_STEPS = {
    "mixup_v1": dict(step=dict(mixup_mode="mixup_v1", mixup_beta=5.0)),
    "treemix_v2": dict(step=dict(mixup_mode="treemix_v2")),
    "treemix_both": dict(step=dict(mixup_mode="treemix_both")),
    "branched": dict(step=dict(branched=True), model=dict(branched=True)),
    "branched_layer": dict(step=dict(branched=True), model=dict(branched_layers=True)),
    "energy_mce": dict(step=dict(loss="mce", energy=True, m_in=25.0, m_out=0.0)),
    "uq_as_class": dict(step=dict(mixup_mode="mixup_v1", mixup_beta=5.0, uq_as_class=True), uq=True),
}
# Phase 33's train CLI runs: scripts/<backbone>/train/<name>, its command
# as the recipe tool rewrites it for the port, with these flags after the
# script's ("$@"): the synthetic root, one epoch; ood_finetune.sh also
# dumps its chart.
STRATEGY_SCRIPTS = (("lxmert", "mixup.sh", ()), ("lxmert", "branched.sh", ()), ("lxmert", "energy.sh", ()),
                    ("lxmert", "ood_finetune.sh", ("--chart",)), ("uniter", "mixup.sh", ()), ("butd", "mixup.sh", ()))


def recipe_argv(script: str, flags=(), **env) -> list:
    """The port CLI's arguments of the one command that ``scripts/<script>``
    runs with ``flags`` (its ``"$@"``) and the environment variables
    ``env`` (``DATA_ROOT``, ``OUTPUT``, ...), through
    ``rgqa_tpu_torch.tools.recipes``."""
    from rgqa_tpu_torch.tools import recipes

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", script)
    cmds = recipes.commands(path, list(flags), env=dict(os.environ, **env))
    if len(cmds) != 1 or cmds[0][1:3] != ["-m", "rgqa_tpu_torch.cli.train"]:
        raise AssertionError(f"{script}: the recipe tool lists {cmds}, want one train CLI command")
    return cmds[0][3:]


def _strategy_batches(root: str, n: int, answers: int, uq: bool, b: int = 32) -> list:
    """``n`` full-width batches of ``b`` rows from the synthetic root's
    train split and its UQ rows: the encoded questions with their TreeMix
    spans (20 tokens), the pack's 36 x 2048 RoIs, one-hot targets over
    ``answers`` answers on the answerable rows (with ``uq`` the last
    column is the UQ answer), ``id_mask`` 0 on the UQ rows."""
    import numpy as np
    from rgqa_tpu_torch.data.batching import to_device
    from rgqa_tpu_torch.data.dataset import EncodedGQA, GQADataset
    from rgqa_tpu_torch.data.tokenizer import WordPieceTokenizer, load_vocab
    from rgqa_tpu_torch.data.tsv import PackedFeatures

    tok = WordPieceTokenizer(load_vocab(os.path.join(root, "vocab.txt")))
    enc = EncodedGQA(GQADataset(root, "train,train_uq", add_uq=True), PackedFeatures(os.path.join(root, "features")),
                     tokenizer=tok, max_text_len=20)
    rng = np.random.default_rng(40)
    out = []
    for _ in range(n):
        idx = rng.choice(len(enc), b, replace=False)
        batch = enc.gather_batch(idx)
        is_uq = np.array([enc.dataset.id2datum[enc.question_ids[i]]["label"] == {"UQ": 1.0} for i in idx])
        target = np.zeros((b, answers), np.float32)
        target[np.arange(b), rng.integers(0, answers - 1 if uq else answers, b)] = 1.0
        target[is_uq] = 0.0
        if uq:
            target[is_uq, -1] = 1.0
        batch.update(target=target, id_mask=(~is_uq).astype(np.float32))
        out.append(to_device(batch, "cuda"))
    return out


def _strategy_model(dropout: float, answers: int, **model_kw):
    import torch
    from rgqa_tpu_torch.models.zoo import build_model, default_config

    cfg = dataclasses.replace(default_config(), num_answers=answers, **model_kw)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, hidden_dropout=dropout, attention_dropout=dropout))
    model, forward = build_model(cfg, use_bf16=True, device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(0), train=True)
    return model, forward


def _strategy_steps(model, forward, init, batches, draws, use_fused, step_kw, extra: int = 0):
    """Steps from ``init`` with a fresh BertAdam, each batch with its
    host draws; (losses, ms per step of ``extra`` more steps after)."""
    import torch
    from rgqa_tpu_torch.config import OptimConfig
    from rgqa_tpu_torch.ops.dropout import DropoutRng
    from rgqa_tpu_torch.train.optimizer import make_optimizer
    from rgqa_tpu_torch.train.step import make_train_step

    model.load_state_dict(init)
    opt = make_optimizer(OptimConfig(), model.parameters(), t_total=len(batches) + extra)
    rng = DropoutRng(device=torch.Generator(device="cuda").manual_seed(1), host=torch.Generator().manual_seed(1))
    step = make_train_step(forward, opt, rng=rng, use_fused=use_fused, **step_kw)
    losses = [step(batch, draws=d)["loss"] for batch, d in zip(batches, draws)]
    torch.cuda.synchronize()
    ms = None
    if extra:
        t0 = time.perf_counter()
        for i in range(extra):
            step(batches[i % len(batches)], draws=draws[i % len(batches)])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / extra
    return [float(x) for x in losses], ms


def phase_strategy_steps(root: str, n: int = 4) -> None:
    """Each strategy's steps at full width, batch 32 (phase 32): from one
    init and one set of host draws per batch (``draw_mixup`` from a
    seeded host generator), through the kernels and the plain versions
    at dropout 0 (34 launches of #1 and ``BWD_PER_STEP`` of #3 a step;
    losses within ``LOSS_RTOL``), and through #4 / #5 at dropout 0.1 (34
    and ``BWD_PER_STEP`` a step, none else; ms per step)."""
    import torch
    from rgqa_tpu_torch.train.step import draw_mixup

    phase = "strategy-steps"
    for name, spec in STRATEGY_STEPS.items():
        kw, uq = spec["step"], spec.get("uq", False)
        answers = 1842 + (1 if uq else 0)  # LXMERT's head, and the UQ class
        batches = _strategy_batches(root, n, answers, uq)
        host = torch.Generator().manual_seed(7)
        draws = [draw_mixup(b, kw["mixup_mode"], kw.get("mixup_alpha", 1.0), kw.get("mixup_beta", 1.0), host)
                 if "mixup_mode" in kw else None for b in batches]
        coins = [d["coin"] for d in draws if d and "coin" in d]
        rows = 64 if "mixup_mode" in kw else 32
        model, forward = _strategy_model(0.0, answers, **spec.get("model", {}))
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        reset_counts()
        k_losses, _ = _strategy_steps(model, forward, init, batches, draws, None, kw)
        counts = read_counts()
        p_losses, _ = _strategy_steps(model, forward, init, batches, draws, False, kw)
        if read_counts() != counts:
            raise AssertionError(f"{phase} {name}: the plain steps launched a kernel")
        want = _step_launches("lxmert", 0.0)
        per_step = {k: c / n for k, c in counts.items()}
        rel = [abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses)]
        del model, forward
        model, forward = _strategy_model(RATE, answers, **spec.get("model", {}))
        init_d = {k: v.detach().clone() for k, v in model.state_dict().items()}
        reset_counts()
        d_losses, _ = _strategy_steps(model, forward, init_d, batches[:2], draws[:2], None, kw)
        d_per_step = {k: c / 2 for k, c in read_counts().items()}
        _, ms = _strategy_steps(model, forward, init_d, batches, draws, None, kw, extra=8)
        log(phase, f"{name} ({', '.join(f'{k}={v}' for k, v in kw.items())}; {answers} answers, {rows} rows"
            + (f"; coins {coins}" if coins else "") + f"): dropout 0 losses kernels "
            f"{[round(x, 4) for x in k_losses]}, plain {[round(x, 4) for x in p_losses]}, max relative gap "
            f"{max(rel):.3e} (bound {LOSS_RTOL:.0e}); launches a step {_shown(per_step)}; dropout {RATE}: "
            f"losses {[round(x, 4) for x in d_losses]}, launches a step {_shown(d_per_step)}, "
            f"{ms:.3f} ms a step (mean of 8 after 4)")
        if per_step != want:
            raise AssertionError(f"{phase} {name}: launches a step {per_step}, want {want}")
        if d_per_step != _step_launches("lxmert", RATE):
            raise AssertionError(f"{phase} {name}: dropout launches a step {d_per_step}")
        if not all(math.isfinite(x) for x in k_losses + p_losses + d_losses) or not max(rel) <= LOSS_RTOL:
            raise AssertionError(f"{phase} {name}: losses {k_losses} vs plain {p_losses}")
        del model, forward, batches, init, init_d
        torch.cuda.empty_cache()


def _shown(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def phase_strategy_cli(tmp: str) -> None:
    """The train CLI with the strategy scripts' flags at full width, one
    epoch each (phase 33): launches of #4 / #5 a step and #1 a
    validation forward (LXMERT 34 / ``BWD_PER_STEP`` / 34, UNITER 12 /
    12 / 12, BUTD none), finite losses, a ``BEST.pth`` that loads back
    with no key missing or unused (the UQ answer a class of the head
    under ``--uq_as_class``; ``LAST.pth`` where the validation accuracy
    stayed 0, so that no ``BEST.pth`` was written), and ``--chart``'s
    pickle of every trained question."""
    import pickle

    import torch
    from rgqa_tpu_torch.checkpoint.convert import load_reference_pth
    from rgqa_tpu_torch.cli import train as train_cli
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.models.zoo import default_config

    phase = "strategy-cli"
    root = os.path.join(tmp, "gqa")
    for backbone_dir, script, extra in STRATEGY_SCRIPTS:
        name = f"{backbone_dir} {script}"
        argv = recipe_argv(f"{backbone_dir}/train/{script}", ["--synthetic", "--epochs", "1", *extra],
                           DATA_ROOT=root, OUTPUT=tmp)
        cfg, _ = parse_cli(argv)
        out = cfg.output
        backbone, batch = cfg.model.backbone, cfg.train.batch_size
        reset_counts()
        t0 = time.perf_counter()
        history = train_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        train_ds = GQADataset(root, cfg.data.train_splits, add_uq=True)
        steps = len(train_ds) // batch
        forwards = math.ceil(len(GQADataset(root, cfg.data.valid_splits)) / batch)
        per = {"lxmert": (34, BWD_PER_STEP, 34), "uniter": (12, 12, 12), "butd": (0, 0, 0)}[backbone]
        want = {k: 0 for k in KERNELS}
        want.update({"fused_attention_dropout": per[0] * steps, "fused_attention_dropout_bwd": per[1] * steps,
                     "fused_attention": per[2] * forwards})
        best = os.path.join(out, "BEST.pth")
        log(phase, f"{name}: train CLI ({' '.join(argv)}) in {seconds:.2f} s: {steps} steps, history {history}; "
            f"launches {_shown(launches)}")
        if launches != want:
            raise AssertionError(f"{phase} {name}: launches {launches}, want {want}")
        if not all(math.isfinite(x) for x in history["loss"]):
            raise AssertionError(f"{phase} {name}: non-finite loss {history['loss']}")
        if not os.path.isfile(best):
            # BEST.pth is written on a validation accuracy above the last
            # best (0 at the start): ood_finetune.sh's half-UQ training
            # can answer UQ to every (answerable) validation question.
            if max(history["valid"]) > 0:
                raise AssertionError(f"{phase} {name}: no BEST.pth (valid {history['valid']})")
            log(phase, f"{name}: validation accuracy stayed 0, so no BEST.pth; LAST.pth loads back instead")
            best = os.path.join(out, "LAST.pth")
        enc = default_config(backbone).encoder
        _, missing, unused = load_reference_pth(best, backbone=backbone, l_layers=enc.l_layers,
                                                x_layers=enc.x_layers, r_layers=enc.r_layers,
                                                num_layers=enc.num_layers, branched=cfg.model.branched)
        heads = {k: tuple(v.shape) for k, v in torch.load(best, map_location="cpu", weights_only=True).items()
                 if k.startswith(("logit_fc.3", "conf_head", "layer_conf"))}
        msg = (f"{name}: {os.path.basename(best)} loads back, {len(missing)} keys missing, {len(unused)} unused; "
               f"heads {heads}")
        if missing or unused:
            raise AssertionError(f"{phase} {msg}: {missing[:3]} {unused[:3]}")
        if cfg.model.uq_as_class and (train_ds.num_answers,) not in [s[:1] for s in heads.values()]:
            raise AssertionError(f"{phase} {msg}: the UQ answer is not a class of the head")
        if cfg.train.chart:
            with open(os.path.join(out, "chart", "epoch_0.pkl"), "rb") as f:
                chart = pickle.load(f)
            if len(chart) != steps * batch or not all(0.0 <= s <= 1.0 for s, _, _ in chart.values()):
                raise AssertionError(f"{phase} {name}: chart of {len(chart)} rows, want {steps * batch}")
            msg += f"; chart/epoch_0.pkl holds {len(chart)} questions"
        log(phase, msg)
        torch.cuda.empty_cache()


def phase_frcnn_cli(keep: str) -> int:
    """``--scorer frcnn`` through the evaluate CLI (phase 34): phase 9's
    ``BEST.pth`` answering, ``--fp32``, batch 256, 34 launches of #1 a
    batch and none else; the answers equal a re-score through the plain
    versions and the confidences (0 or 1) the coverage of the root's
    questions against its pack's ``objects_id``, computed again on the
    host.  Returns the run's launches of #1."""
    import numpy as np
    import torch
    from rgqa_tpu_torch.cli import evaluate
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.data.tsv import PackedFeatures
    from rgqa_tpu_torch.scorers import coverage_scores, load_object_vocab

    phase = "frcnn-cli"
    root, best = os.path.join(keep, "gqa"), os.path.join(keep, "BEST.pth")
    argv = ["--synthetic", "--data_root", root, "--test", "testdev", "--fp32", "--load", best,
            "--scorer", "frcnn", "--batchSize", "256", "--output", os.path.join(keep, "frcnn_eval")]
    rows, launches = _scorer_cli(phase, argv, root, 0)
    before = read_counts()
    cfg, device, plan = evaluate.parse_args(argv)
    runner = evaluate.make_runner(cfg, device, plan["scorer"])
    fused = runner.forward
    runner.forward = lambda batch, **kw: fused(batch, use_fused=False, **kw)
    path = os.path.join(keep, "frcnn_plain.json")
    runner.coverage_ood_evaluate(runner._encode(GQADataset(root, "testdev", add_uq=True)),
                                 os.path.join(root, "objects_vocab.txt"), dump=path)
    torch.cuda.synchronize()
    if read_counts() != before:
        raise AssertionError(f"{phase}: the plain re-score launched a kernel")
    _held_to_plain(phase, rows, path, 0.0)
    feats = PackedFeatures(os.path.join(root, "features"))
    data = GQADataset(root, "testdev", add_uq=True).data
    host = coverage_scores([d["sent"] for d in data], [np.asarray(feats.objects_id[feats.index[d["img_id"]]])
                                                       for d in data],
                           load_object_vocab(os.path.join(root, "objects_vocab.txt")))
    same = all(rows[d["question_id"]][1] == float(c) for d, c in zip(data, host))
    log(phase, f"confidences equal the host's coverage of {len(data)} questions: {same} "
        f"({int(host.sum())} covered)")
    if not same:
        raise AssertionError(f"{phase}: the confidences differ from the host's coverage")
    del runner
    torch.cuda.empty_cache()
    return launches


def phase_strategies(keep: str) -> None:
    """Phases 32-34, each timed."""
    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_strategies_") as tmp:
        from rgqa_tpu_torch.data.synthetic import make_synthetic_gqa

        make_synthetic_gqa(os.path.join(tmp, "gqa"))
        timed("32 strategy steps", phase_strategy_steps, os.path.join(tmp, "gqa"))
        timed("33 strategy CLIs", phase_strategy_cli, tmp)
    timed("34 frcnn CLI", phase_frcnn_cli, keep)


# ---------------------------------------------------------------------------
# Phases 35-36: the train CLI's remaining strategies.
# ---------------------------------------------------------------------------


def _launches(**counts) -> dict:
    want = {name: 0 for name in KERNELS}
    want.update(counts)
    return want


# Launches per LXMERT step (34 attention calls a forward, BWD_PER_STEP
# backward calls a step): VILLA's clean forward and three inner passes;
# the min-max and weighted pairs' two forwards; distillation's teacher
# forward (eval, #1) beside the student's step.
NEW_STEP_LAUNCHES = {
    "adv": {0.0: _launches(fused_attention=34 + 3 * 34, fused_attention_bwd=3 * BWD_PER_STEP),
            RATE: _launches(fused_attention=34, fused_attention_dropout=3 * 34,
                            fused_attention_dropout_bwd=3 * BWD_PER_STEP)},
    "distill_online": {0.0: _launches(fused_attention=2 * 34, fused_attention_bwd=BWD_PER_STEP),
                       RATE: _launches(fused_attention=34, fused_attention_dropout=34,
                                       fused_attention_dropout_bwd=BWD_PER_STEP)},
}
for _pair in ("resampling", "woods", "weight"):
    NEW_STEP_LAUNCHES[_pair] = {
        0.0: _launches(fused_attention=2 * 34, fused_attention_bwd=2 * BWD_PER_STEP),
        RATE: _launches(fused_attention_dropout=2 * 34, fused_attention_dropout_bwd=2 * BWD_PER_STEP)}
# Phase 36's train CLI runs: scripts/lxmert/train/<name> through the
# recipe tool, one epoch (distill_online.sh's TEACHER and weight.sh's
# CLIP_PATH from the environment).
NEW_STRATEGY_SCRIPTS = ("adv.sh", "resampling.sh", "poem.sh", "woods.sh", "distill_online.sh", "weight.sh")
OPTIMS = (("adam", False), ("adamw", False), ("adamax", False), ("sgd", False), ("rms", False), ("bert", True))


def _strategy_run(name, model, init, step_args, use_fused, forward, teacher_forward, extra: int = 0):
    """Steps of ``name`` from ``init`` with a fresh BertAdam over
    ``step_args``; (losses, the step)."""
    import torch
    from rgqa_tpu_torch.config import OptimConfig
    from rgqa_tpu_torch.ops.dropout import DropoutRng
    from rgqa_tpu_torch.tools.strategy_steps import make_strategy_step
    from rgqa_tpu_torch.train.optimizer import make_optimizer

    model.load_state_dict(init)
    opt = make_optimizer(OptimConfig(), model.parameters(), t_total=len(step_args) + extra)
    rng = DropoutRng(device=torch.Generator(device="cuda").manual_seed(1), host=torch.Generator().manual_seed(1))
    step = make_strategy_step(name, forward, opt, rng=rng, use_fused=use_fused, teacher_forward=teacher_forward)
    losses = [step(*args)["loss"] for args in step_args]
    torch.cuda.synchronize()
    return [float(x) for x in losses], step


def phase_new_strategy_steps(root: str, n: int = 2) -> None:
    """Phase 35: each new strategy's step at full width, batch 32, from
    one init and one set of host draws: at dropout 0, ``n`` steps through
    the kernels and the plain versions (losses within ``LOSS_RTOL``,
    launches a step ``NEW_STEP_LAUNCHES``); at dropout 0.1 through #4 /
    #5 (and the teacher's or the clean forward's #1), after a warm-up
    step: launches a step and the wall over 4 steps, then the device
    time a step (``torch.profiler``, 2 steps)."""
    import torch
    from rgqa_tpu_torch.models.zoo import build_model, default_config
    from rgqa_tpu_torch.tools.profile_forward import _device_time
    from rgqa_tpu_torch.tools.strategy_steps import STRATEGIES, strategy_inputs

    phase = "new-strategy-steps"
    batches = _strategy_batches(root, n + 1, 1842, False)
    _, teacher = build_model(default_config(), use_bf16=True, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(2))
    for name in STRATEGIES:
        step_args = strategy_inputs(name, batches)[:n]
        teacher_forward = teacher if name == "distill_online" else None
        model, forward = _strategy_model(0.0, 1842)
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        reset_counts()
        k_losses, _ = _strategy_run(name, model, init, step_args, None, forward, teacher_forward)
        counts = read_counts()
        p_losses, _ = _strategy_run(name, model, init, step_args, False, forward, teacher_forward)
        if read_counts() != counts:
            raise AssertionError(f"{phase} {name}: the plain steps launched a kernel")
        per_step = {k: c / n for k, c in counts.items()}
        rel = [abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses)]
        del model, forward
        model, forward = _strategy_model(RATE, 1842)
        init_d = {k: v.detach().clone() for k, v in model.state_dict().items()}
        d_losses, step = _strategy_run(name, model, init_d, step_args[:1], None, forward, teacher_forward,
                                       extra=8)
        reset_counts()
        t0 = time.perf_counter()
        for i in range(4):
            step(*step_args[i % n])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 4
        d_per_step = {k: c / 4 for k, c in read_counts().items()}
        classes = _device_time(lambda: step(*step_args[0]), 2)
        device_ms = sum(ms for ms, _ in classes.values())
        attention = sum(ms for cls, (ms, _) in classes.items() if cls.startswith("attention"))
        log(phase, f"{name}: dropout 0 losses kernels {[round(x, 4) for x in k_losses]}, plain "
            f"{[round(x, 4) for x in p_losses]}, max relative gap {max(rel):.3e} (bound {LOSS_RTOL:.0e}); "
            f"launches a step {_shown(per_step)}; dropout {RATE}: first loss {d_losses[0]:.4f}, "
            f"launches a step {_shown(d_per_step)}; device {device_ms:.3f} ms a step (attention "
            f"{attention:.3f}), wall {wall:.3f} ms (before the profile), idle share {1 - device_ms / wall:.4f}")
        if per_step != NEW_STEP_LAUNCHES[name][0.0]:
            raise AssertionError(f"{phase} {name}: launches a step {per_step}")
        if d_per_step != NEW_STEP_LAUNCHES[name][RATE]:
            raise AssertionError(f"{phase} {name}: dropout launches a step {d_per_step}")
        if not all(math.isfinite(x) for x in k_losses + p_losses + d_losses) or not max(rel) <= LOSS_RTOL:
            raise AssertionError(f"{phase} {name}: losses {k_losses} vs plain {p_losses}")
        del model, forward, init, init_d, step
        torch.cuda.empty_cache()


def _pretraining_pth(path: str, seed: int) -> str:
    """A random full-width 9500-answer ``model_LXRT.pth``."""
    import torch
    from rgqa_tpu_torch.checkpoint.convert import to_reference_state_dict
    from rgqa_tpu_torch.models.lxmert import LxmertPretraining
    from rgqa_tpu_torch.models.zoo import default_config, init_weights

    with torch.device("cuda"):
        model = LxmertPretraining(default_config().encoder)
    init_weights(model, torch.Generator(device="cuda").manual_seed(seed))
    torch.save(to_reference_state_dict(model.state_dict(), backbone="lxmert_pretrain"), path)
    del model
    return path


def _load_lxmert_qa_run(tmp: str, root: str) -> None:
    """``--loadLXMERTQA <prefix>``: the ``_LXRT.pth`` suffix rule, the
    counts printed against ``all_ans.json`` and the GQA answers, the
    runner's weights against the file's before its first step; then its
    epoch (34 #4 / 32 #5 a step)."""
    import contextlib
    import io

    import torch
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.pretrain import AnswerTable
    from rgqa_tpu_torch.runner import GQARunner

    phase = "new-strategy-cli"
    prefix = os.path.join(tmp, "qa_pretrained")
    _pretraining_pth(prefix + "_LXRT.pth", seed=6)
    with open(os.path.join(root, "trainval_label2ans.json")) as f:
        answers = json.load(f)
    table = ["man", "woman"] + answers[::2]
    with open(os.path.join(root, "all_ans.json"), "w") as f:
        json.dump([{"ans": a, "dsets": ["gqa"]} for a in table], f)
    argv = ["--synthetic", "--data_root", root, "--epochs", "1", "--batchSize", "32",
            "--output", os.path.join(tmp, "loadLXMERTQA"), "--loadLXMERTQA", prefix]
    cfg, _ = parse_cli(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runner = GQARunner(cfg)
    printed = out.getvalue()
    real = [AnswerTable.convert_ans(a) for a in runner.label2ans[: runner.model_cfg.num_answers]]  # UQ: no logit
    loaded = sum(a in set(table) for a in real)
    line = f"Loaded {loaded} answers from LXRTQA pre-training and {len(real) - loaded} not"
    ref = torch.load(prefix + "_LXRT.pth", map_location="cpu", weights_only=True)
    ids = {a: i for i, a in enumerate(table)}
    sd = {k: v.detach().float().cpu() for k, v in runner.model.state_dict().items()}
    want_w = torch.stack([ref["answer_head.logit_fc.3.weight"][ids[a]] if a in ids
                          else torch.zeros(ref["answer_head.logit_fc.3.weight"].shape[1]) for a in real])
    same = {
        "word embeddings": torch.equal(sd["lxmert.embeddings.word_embeddings.weight"],
                                       ref["bert.embeddings.word_embeddings.weight"]),
        "last cross layer": torch.equal(sd["lxmert.x_layers.4.visn_mlp.out.weight"],
                                        ref["bert.encoder.x_layers.4.visn_output.dense.weight"]),
        "head dense": torch.equal(sd["answer_head.dense.weight"], ref["answer_head.logit_fc.0.weight"]),
        "head rows": torch.equal(sd["answer_head.logits.weight"], want_w),
    }
    log(phase, f"--loadLXMERTQA {prefix} (the _LXRT.pth file, all_ans.json of {len(table)} answers): printed "
        f"{printed.strip()!r}, want {line!r}; the file's weights before the first step: {same}")
    if line not in printed or not all(same.values()):
        raise AssertionError(f"{phase}: --loadLXMERTQA printed {printed!r}, weights {same}")
    reset_counts()
    history = runner.train()
    torch.cuda.synchronize()
    steps = len(runner.train_set) // 32
    forwards = math.ceil(len(runner.valid_set) / 32)
    want = _launches(fused_attention_dropout=34 * steps, fused_attention_dropout_bwd=BWD_PER_STEP * steps,
                     fused_attention=34 * forwards)
    launches = read_counts()
    log(phase, f"--loadLXMERTQA epoch: history {history}, launches {_shown(launches)}")
    if launches != want or not all(math.isfinite(x) for x in history["loss"]):
        raise AssertionError(f"{phase}: --loadLXMERTQA launches {launches}, want {want}; {history}")
    del runner
    torch.cuda.empty_cache()


def _optim_steps(root: str) -> None:
    """One RP step at full width, batch 32, dropout 0.1, of each
    ``--optim`` and of ``--bf16_moments``, from one init: finite losses,
    every parameter that takes a gradient moved, the moments' dtype."""
    import torch
    from rgqa_tpu_torch.config import OptimConfig
    from rgqa_tpu_torch.ops.dropout import DropoutRng
    from rgqa_tpu_torch.train.optimizer import make_optimizer
    from rgqa_tpu_torch.train.step import make_train_step

    phase = "new-strategy-cli"
    batch = _strategy_batches(root, 1, 1842, False)[0]
    model, forward = _strategy_model(RATE, 1842)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for name, bf16 in OPTIMS:
        model.load_state_dict(init)
        opt = make_optimizer(OptimConfig(name=name, lr=1e-4, bf16_moments=bf16), model.parameters())
        rng = DropoutRng(device=torch.Generator(device="cuda").manual_seed(1),
                         host=torch.Generator().manual_seed(1))
        step = make_train_step(forward, opt, sample_pair=True, rng=rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(batch)["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        moved = sum(not torch.equal(p.detach(), init[k]) for k, p in model.named_parameters() if p.grad is not None)
        graded = sum(p.grad is not None for p in model.parameters())
        dtypes = sorted({str(v.dtype) for s in opt.state.values() for v in s.values() if torch.is_tensor(v)
                         and v.dim() > 0})
        log(phase, f"--optim {name}{' --bf16_moments' if bf16 else ''}: {type(opt).__name__}, loss {loss:.4f}, "
            f"{moved} of {graded} parameters with a gradient moved, state {dtypes}, first step {ms:.1f} ms")
        if not math.isfinite(loss) or moved != graded or (bf16 and dtypes != ["torch.bfloat16"]):
            raise AssertionError(f"{phase}: --optim {name} (bf16 {bf16}): loss {loss}, moved {moved} of {graded}")
    del model, forward, init
    torch.cuda.empty_cache()


def phase_new_strategy_cli(tmp: str) -> None:
    """Phase 36: the strategy scripts' train CLIs at full width, one epoch
    each, held to their launches a step and a validation forward (the
    weight run's CLIP image forwards add 12 #1 each), finite losses and a
    ``LAST.pth`` that loads back whole; ``--loadLXMERTQA``; each
    ``--optim``."""
    import torch
    from rgqa_tpu_torch.checkpoint.convert import load_reference_pth
    from rgqa_tpu_torch.cli import train as train_cli
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.data.dataset import GQADataset

    phase = "new-strategy-cli"
    root = os.path.join(tmp, "gqa")
    vanilla = os.path.join(tmp, "vanilla")
    train_cli.main(["--synthetic", "--data_root", root, "--epochs", "1", "--batchSize", "32", "--output", vanilla])
    clip = _hf_clip_dir(os.path.join(tmp, "clip"), seed=3)
    per_step = {"adv.sh": NEW_STEP_LAUNCHES["adv"][RATE], "distill_online.sh":
                NEW_STEP_LAUNCHES["distill_online"][RATE], "weight.sh": NEW_STEP_LAUNCHES["weight"][RATE]}
    for name in NEW_STRATEGY_SCRIPTS:
        argv = recipe_argv(f"lxmert/train/{name}", ["--synthetic", "--epochs", "1"], DATA_ROOT=root, OUTPUT=tmp,
                           TEACHER=os.path.join(vanilla, "LAST"), CLIP_PATH=clip)
        cfg, _ = parse_cli(argv)
        out = cfg.output
        batch = cfg.train.batch_size
        reset_counts()
        t0 = time.perf_counter()
        history = train_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        minmax = cfg.train.strategy in ("resampling", "poem", "woods")
        split = cfg.data.train_pos if minmax else cfg.data.train_splits
        steps = len(GQADataset(root, split, add_uq=True)) // batch
        forwards = math.ceil(len(GQADataset(root, cfg.data.valid_splits)) / batch)
        one = per_step.get(name, NEW_STEP_LAUNCHES["resampling"][RATE])
        want = {k: v * steps for k, v in one.items()}
        want["fused_attention"] += 34 * forwards
        clip_calls = (launches["fused_attention"] - want["fused_attention"]) / 12 if name == "weight.sh" else 0
        if name == "weight.sh":  # the CLIP image forwards: 12 #1 each, at least one
            want["fused_attention"] = launches["fused_attention"]
        log(phase, f"{name}: train CLI ({' '.join(argv)}) in {seconds:.2f} s: {steps} steps, history {history}; "
            f"launches {_shown(launches)}" + (f" ({clip_calls:g} CLIP image forwards)" if clip_calls else ""))
        if launches != want or (name == "weight.sh" and not (clip_calls >= 1 and clip_calls == int(clip_calls))):
            raise AssertionError(f"{phase} {name}: launches {launches}, want {want}")
        if not all(math.isfinite(x) for x in history["loss"]):
            raise AssertionError(f"{phase} {name}: non-finite loss {history['loss']}")
        _, missing, unused = load_reference_pth(os.path.join(out, "LAST.pth"))
        if missing or unused:
            raise AssertionError(f"{phase} {name}: LAST.pth missing {missing[:3]}, unused {unused[:3]}")
        torch.cuda.empty_cache()
    _load_lxmert_qa_run(tmp, root)
    _optim_steps(root)


def phase_new_strategies() -> None:
    """Phases 35-36 in one temporary directory, each timed."""
    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_new_strategies_") as tmp:
        from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa

        # Half the default root's questions: 4 steps an epoch at batch 32.
        make_synthetic_gqa(os.path.join(tmp, "gqa"), SyntheticSpec(n_train=128, n_valid=32))
        timed("35 new strategy steps", phase_new_strategy_steps, os.path.join(tmp, "gqa"))
        timed("36 new strategy CLIs", phase_new_strategy_cli, tmp)


# ---------------------------------------------------------------------------
# Phases 37-41: the CLIP weight model's training, distillation, the
# verifier, compute_param.
# ---------------------------------------------------------------------------

# Launches per joint step of --strategy weight --update_weight_model: the
# CLIP vision tower's forward (12 of #1) and backward (12 of #3) beside
# the weighted pair's two LXMERT forwards and backwards.
WEIGHT_MODEL_LAUNCHES = {
    0.0: _launches(fused_attention=CLIP_PER_FORWARD + 2 * 34,
                   fused_attention_bwd=CLIP_PER_FORWARD + 2 * BWD_PER_STEP),
    RATE: _launches(fused_attention=CLIP_PER_FORWARD, fused_attention_bwd=CLIP_PER_FORWARD,
                    fused_attention_dropout=2 * 34, fused_attention_dropout_bwd=2 * BWD_PER_STEP),
}
# The parameter counts of compute_param (ModelConfig defaults), equal to
# the JAX package's (tests/test_torch_surfaces.py, on the CPU).
PARAM_COUNTS = {"butd": 17_134_306, "caps": 110_668_033, "lxmert": 211_952_178, "uniter": 115_082_034,
                "vilt": 115_972_914}


def _joint_step(model, forward, clip, init, clip_init, step_args, use_fused):
    """A fresh joint step from ``init`` / ``clip_init`` (BertAdam for the
    model, the strategy's Adam for CLIP) and its losses over
    ``step_args``; (losses, loss_w, the step)."""
    import torch
    from rgqa_tpu_torch.config import OptimConfig
    from rgqa_tpu_torch.ops.dropout import DropoutRng
    from rgqa_tpu_torch.tools.strategy_steps import make_strategy_step
    from rgqa_tpu_torch.train.optimizer import make_optimizer

    model.load_state_dict(init)
    clip.load_state_dict(clip_init)
    opt = make_optimizer(OptimConfig(), model.parameters(), t_total=100)
    rng = DropoutRng(device=torch.Generator(device="cuda").manual_seed(1), host=torch.Generator().manual_seed(1))
    step = make_strategy_step("weight_model", forward, opt, rng=rng, use_fused=use_fused, clip_model=clip)
    aux = [step(*args) for args in step_args]
    torch.cuda.synchronize()
    return [float(a["loss"]) for a in aux], [float(a["loss_w"]) for a in aux], step


def phase_weight_model_steps(root: str, n: int = 2) -> None:
    """Phase 37: the joint step of ``--strategy weight
    --update_weight_model`` at full width, batch 32: LXMERT 9/5/5 x 768
    and a full-width ViT-B/32 CLIP (f32 weights; bf16 compute, then
    ``--fp32``), from one init and one set of roll shifts: at dropout 0,
    ``n`` steps through the kernels and through the plain versions
    (``loss`` and ``loss_w`` within ``LOSS_RTOL``; launches a step
    ``WEIGHT_MODEL_LAUNCHES``); at dropout 0.1, launches a step, the wall
    over 4 steps, the device time a step (``torch.profiler``, 2 steps)
    and the peak device memory."""
    import torch
    from rgqa_tpu_torch.models.clip import ClipConfig, ClipModel, init_clip_weights
    from rgqa_tpu_torch.models.zoo import build_model, default_config
    from rgqa_tpu_torch.tools.profile_forward import _device_time
    from rgqa_tpu_torch.tools.strategy_steps import strategy_inputs, with_clip_inputs

    phase = "weight-model-steps"
    ccfg = ClipConfig()
    batches = [with_clip_inputs(b, ccfg, seed=i) for i, b in enumerate(_strategy_batches(root, n + 1, 1842, False))]
    step_args = strategy_inputs("weight_model", batches)
    for fp32 in (False, True):
        what = "--fp32" if fp32 else "bf16"
        with torch.device("cuda"):
            clip = ClipModel(ccfg, torch.float32 if fp32 else torch.bfloat16)
        init_clip_weights(clip, torch.Generator(device="cuda").manual_seed(3))
        clip.train()
        clip_init = {k: v.detach().clone() for k, v in clip.state_dict().items()}
        results = {}
        for dropout in (0.0, RATE):
            cfg = dataclasses.replace(default_config(), num_answers=1842)
            cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
                cfg.encoder, hidden_dropout=dropout, attention_dropout=dropout))
            model, forward = build_model(cfg, use_bf16=not fp32, device="cuda", train=True,
                                         generator=torch.Generator(device="cuda").manual_seed(0))
            init = {k: v.detach().clone() for k, v in model.state_dict().items()}
            if dropout == 0.0:
                reset_counts()
                k_loss, k_w, _ = _joint_step(model, forward, clip, init, clip_init, step_args[:n], None)
                counts = read_counts()
                p_loss, p_w, _ = _joint_step(model, forward, clip, init, clip_init, step_args[:n], False)
                if read_counts() != counts:
                    raise AssertionError(f"{phase} {what}: the plain steps launched a kernel")
                rel = [abs(a - b) / abs(b) for a, b in zip(k_loss + k_w, p_loss + p_w)]
                results[0.0] = {k: c / n for k, c in counts.items()}
                log(phase, f"{what} dropout 0: loss kernels {[round(x, 4) for x in k_loss]}, plain "
                    f"{[round(x, 4) for x in p_loss]}; loss_w kernels {[round(x, 4) for x in k_w]}, plain "
                    f"{[round(x, 4) for x in p_w]}; max relative gap {max(rel):.3e} (bound {LOSS_RTOL:.0e}); "
                    f"launches a step {_shown(results[0.0])}")
                if not all(math.isfinite(x) for x in k_loss + p_loss + k_w + p_w) or not max(rel) <= LOSS_RTOL:
                    raise AssertionError(f"{phase} {what}: losses {k_loss}/{k_w} vs plain {p_loss}/{p_w}")
                if len(set(round(x, 6) for x in k_w)) < 2:
                    raise AssertionError(f"{phase} {what}: loss_w never moved: {k_w}")
            else:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                d_loss, d_w, step = _joint_step(model, forward, clip, init, clip_init, step_args[:1], None)
                reset_counts()
                t0 = time.perf_counter()
                for i in range(4):
                    step(*step_args[i % n])
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / 4
                results[RATE] = {k: c / 4 for k, c in read_counts().items()}
                peak = torch.cuda.max_memory_allocated() / 2**30
                classes = _device_time(lambda: step(*step_args[0]), 2)
                device_ms = sum(ms for ms, _ in classes.values())
                top = ", ".join(f"{c} {ms:.3f}" for c, (ms, _) in sorted(classes.items(), key=lambda kv: -kv[1][0])[:6])
                log(phase, f"{what} dropout {RATE}: first loss {d_loss[0]:.4f}, loss_w {d_w[0]:.4f}; launches a "
                    f"step {_shown(results[RATE])}; device {device_ms:.3f} ms a step ({top}), wall {wall:.3f} ms "
                    f"(before the profile), idle share {1 - device_ms / wall:.4f}; peak device memory "
                    f"{peak:.2f} GiB")
                if not all(math.isfinite(x) for x in d_loss + d_w):
                    raise AssertionError(f"{phase} {what}: non-finite dropout losses {d_loss} {d_w}")
            del model, forward, init
            torch.cuda.empty_cache()
        for rate, want in WEIGHT_MODEL_LAUNCHES.items():
            if results[rate] != want:
                raise AssertionError(f"{phase} {what}: launches a step at dropout {rate} {results[rate]}, want {want}")
        del clip, clip_init
        torch.cuda.empty_cache()


def phase_weight_model_cli(tmp: str, root: str) -> tuple[str, str]:
    """Phase 38: ``scripts/lxmert/train/weight.sh --update_weight_model``
    at full width, one epoch on the 128-question root, CLIP a random
    full-width HF directory, its pixels the root's CLIP pack: launches
    ``WEIGHT_MODEL_LAUNCHES`` a step at dropout 0.1 and 34 of #1 a
    validation forward; ``LAST.pth`` loads back whole; ``LAST_clip.pth``
    holds the trained tower, which ``clip_params/`` exports and which
    moved off the source; then ``--scorer clip --clip_path
    <out>/clip_params`` through the evaluate CLI scores with that tower
    (phase 29's checks, re-scored through the plain versions).  Returns
    (the run's directory, its ``LAST.pth``)."""
    import torch
    from rgqa_tpu_torch.checkpoint.convert import load_clip_state_dict, load_reference_pth
    from rgqa_tpu_torch.cli import train as train_cli
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.data.dataset import GQADataset

    phase = "weight-model-cli"
    clip = _hf_clip_dir(os.path.join(tmp, "clip"), seed=4)
    out = os.path.join(tmp, "weight_model")
    argv = recipe_argv("lxmert/train/weight.sh", ["--synthetic", "--epochs", "1", "--output", out,
                                                  "--update_weight_model"], DATA_ROOT=root, OUTPUT=tmp, CLIP_PATH=clip)
    cfg, _ = parse_cli(argv)
    reset_counts()
    t0 = time.perf_counter()
    history = train_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    steps = len(GQADataset(root, cfg.data.train_splits, add_uq=True)) // cfg.train.batch_size
    forwards = math.ceil(len(GQADataset(root, cfg.data.valid_splits)) / cfg.train.batch_size)
    want = {k: v * steps for k, v in WEIGHT_MODEL_LAUNCHES[RATE].items()}
    want["fused_attention"] += 34 * forwards
    log(phase, f"weight.sh --update_weight_model: train CLI ({' '.join(argv)}) in {seconds:.2f} s: {steps} steps, "
        f"history {history}; launches {_shown(launches)}")
    if launches != want or not all(math.isfinite(x) for x in history["loss"]):
        raise AssertionError(f"{phase}: launches {launches}, want {want}; history {history}")
    _, missing, unused = load_reference_pth(os.path.join(out, "LAST.pth"))
    if missing or unused:
        raise AssertionError(f"{phase}: LAST.pth missing {missing[:3]}, unused {unused[:3]}")
    trained = torch.load(os.path.join(out, "LAST_clip.pth"), map_location="cpu", weights_only=True)
    exported = load_clip_state_dict(os.path.join(out, "clip_params"))
    source = load_clip_state_dict(clip)
    same = all(torch.equal(exported[k], v.float()) for k, v in trained["params"].items())
    moved = sum(not torch.equal(source[k], v) for k, v in exported.items())
    log(phase, f"LAST_clip.pth: step {trained['step']}, Adam state of {len(trained['optimizer']['state'])} "
        f"tensors; clip_params/ holds its params: {same}; {moved} of {len(exported)} tensors moved off --clip_path")
    if not same or trained["step"] != steps or moved < len(exported) // 2:
        raise AssertionError(f"{phase}: the exported tower is not the trained one (same {same}, moved {moved})")
    phase_clip_cli(tmp, root, os.path.join(out, "LAST.pth"), os.path.join(out, "clip_params"),
                   phase="weight-model-clip-cli")
    torch.cuda.empty_cache()
    return out, os.path.join(out, "LAST.pth")


def phase_distill_cli(tmp: str, root: str, teacher: str) -> None:
    """Phase 39: the distillation CLI at full width from ``teacher`` (phase
    38's ``LAST.pth``), batch 256: ``--n_candidates 256 --passes 2`` at
    dropout 0.1 (34 launches of #4 a pass and batch, none else), the
    split written; one pass of the candidates through #4 held to its
    plain version on the same seeds (answers on ``MIN_LABEL_AGREEMENT``,
    confidences within ``CONF_TOL``); then ``--teacher_path a,b`` (the
    ensemble: 34 launches of #1 a batch and teacher)."""
    import torch
    from rgqa_tpu_torch import distill
    from rgqa_tpu_torch.cli import distill as distill_cli
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.runner import GQARunner
    from rgqa_tpu_torch.scorers.core import make_dropout_scorer

    import numpy as np

    phase = "distill-cli"
    base = ["--synthetic", "--data_root", root, "--batchSize", "256", "--output", os.path.join(tmp, "distill")]
    # tau_aq_c 0 / tau_aq_v 1: every candidate the teacher is not sure is
    # unanswerable becomes a pseudo-AQ row (a random teacher's confidences
    # straddle no default threshold).
    argv = base + ["--load", teacher, "--n_candidates", "256", "--passes", "2", "--output_name", "distill_train",
                   "--tau_aq_c", "0", "--tau_aq_v", "1"]
    reset_counts()
    t0 = time.perf_counter()
    rows = distill_cli.main(argv)
    torch.cuda.synchronize()
    launches = read_counts()
    want = _launches(fused_attention_dropout=34 * 2)
    labels = [next(iter(r["label"])) for r in rows]
    log(phase, f"distill CLI ({' '.join(argv)}) in {time.perf_counter() - t0:.2f} s: {len(rows)} rows "
        f"({labels.count('UQ')} pseudo-UQ); launches {_shown(launches)}")
    with open(os.path.join(root, "distill_train.json")) as f:
        written = json.load(f)
    if launches != want or written != rows or not rows:
        raise AssertionError(f"{phase}: launches {launches}, want {want}; {len(rows)} rows, {len(written)} written")

    cfg, _ = parse_cli(base + ["--load", teacher])
    runner = GQARunner(cfg)
    cands = distill.sample_repaired(runner.dataset.data, np.random.default_rng(0), 256)
    encoded = runner._encode(GQADataset.from_rows(cands, ans2label=runner.dataset.ans2label,
                                                  label2ans=runner.dataset.label2ans))
    reset_counts()
    kernel = runner.score_split(encoded, scorer=make_dropout_scorer(runner.forward, seed_list=(0,)))
    k_launches = read_counts()
    fused = runner.forward
    runner.forward = lambda batch, **kw: fused(batch, use_fused=False, **kw)
    plain = runner.score_split(encoded, scorer=make_dropout_scorer(runner.forward, seed_list=(0,)))
    if read_counts() != k_launches:
        raise AssertionError(f"{phase}: the plain pass launched a kernel")
    agree = sum(kernel[q][0] == plain[q][0] for q in kernel) / len(kernel)
    dconf = max(abs(kernel[q][1] - plain[q][1]) for q in kernel)
    log(phase, f"one MC-dropout pass (seed 0, dropout {RATE}) of {len(kernel)} candidates through #4 "
        f"({_shown(k_launches)}) vs plain: answers agree on {agree:.4f} (want >= {MIN_LABEL_AGREEMENT}), "
        f"max|conf diff| {dconf:.3e} (bound {CONF_TOL:.0e})")
    if k_launches != _launches(fused_attention_dropout=34) or agree < MIN_LABEL_AGREEMENT or not dconf <= CONF_TOL:
        raise AssertionError(f"{phase}: the kernel pass disagrees with the plain pass")
    del runner

    second = os.path.join(tmp, "teacher_b.pth")
    shutil.copy(teacher, second)
    ens = base + ["--teacher_path", f"{teacher},{second}", "--output_name", "ensemble_train"]
    n_rows = len({d["question_id"] for d in GQADataset(root, parse_cli(base)[0].data.train_splits).data})
    reset_counts()
    rows = distill_cli.main(ens)
    torch.cuda.synchronize()
    launches = read_counts()
    want = _launches(fused_attention=34 * 2 * math.ceil(n_rows / 256))
    scores = [next(iter(r["label"].values())) for r in rows]
    log(phase, f"ensemble ({' '.join(ens)}): {len(rows)} rows, scores {min(scores):.4f}..{max(scores):.4f}; "
        f"launches {_shown(launches)}")
    if launches != want or len(rows) != n_rows or not all(0.0 <= x <= 1.0 for x in scores):
        raise AssertionError(f"{phase}: ensemble launches {launches}, want {want}; {len(rows)} rows of {n_rows}")
    torch.cuda.empty_cache()


def phase_verifier(tmp: str, root: str, answerer_pth: str) -> None:
    """Phase 40: the statement verifier at full width: the answerer an
    evaluation runner (bf16) loading ``answerer_pth``, the verifier a
    one-logit LXMERT at dropout 0.1; ``VerifierTrainer.train`` one epoch at
    32 questions a step (3 x 32 statement rows: 34 #1 the answerer's top-k
    forward, 34 #4 and ``BWD_PER_STEP`` #5 the verifier's step), then
    ``ood_evaluate`` on testdev (34 #1 a batch for the answers and 34 for
    the verifier's scores); finite losses and metrics."""
    import torch
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.runner import GQARunner
    from rgqa_tpu_torch.verifier import VerifierTrainer

    phase = "verifier"
    base = ["--synthetic", "--data_root", root, "--batchSize", "32"]
    acfg, _ = parse_cli(base + ["--load", answerer_pth, "--output", os.path.join(tmp, "answerer")])
    vcfg, _ = parse_cli(base + ["--strategy", "separate", "--output", os.path.join(tmp, "verifier")])
    answerer, ver = GQARunner(acfg, init_train=False), GQARunner(vcfg)
    trainer = VerifierTrainer(ver, answerer, topk=5, seed=0)
    encoded = ver._encode(GQADataset(root, "train,train_uq", add_uq=True))
    reset_counts()
    t0 = time.perf_counter()
    losses = trainer.train(encoded, epochs=1, batch_size=32)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    steps = len(encoded) // 32
    t_launches = read_counts()
    want = _launches(fused_attention=34 * steps, fused_attention_dropout=34 * steps,
                     fused_attention_dropout_bwd=BWD_PER_STEP * steps)
    test = ver._encode(GQADataset(root, "testdev", add_uq=True))
    reset_counts()
    results = trainer.ood_evaluate(test, dump=os.path.join(tmp, "verifier_predict.json"))
    torch.cuda.synchronize()
    e_launches = read_counts()
    e_want = _launches(fused_attention=2 * 34 * math.ceil(len(test) / 32))
    log(phase, f"train: {steps} steps of 3 x 32 statements in {train_s:.2f} s, losses "
        f"{[round(x, 4) for x in losses]}, launches {_shown(t_launches)}; ood_evaluate on {len(test)} questions: "
        f"auaf {results['auaf']:.4f}, fpr@0.95acc {results['fpr@0.95acc']:.4f}, full_acc {results['full_acc']:.4f}, "
        f"launches {_shown(e_launches)}")
    if t_launches != want or e_launches != e_want:
        raise AssertionError(f"{phase}: launches {t_launches} / {e_launches}, want {want} / {e_want}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses) or not all(
            math.isfinite(results[k]) for k in ("auaf", "fpr@0.95acc", "full_acc")):
        raise AssertionError(f"{phase}: losses {losses}, results {results}")
    del answerer, ver, trainer
    torch.cuda.empty_cache()


def phase_compute_param() -> None:
    """Phase 41: ``cli.compute_param`` for every backbone (the models on the
    ``meta`` device: nothing allocated), held to ``PARAM_COUNTS``."""
    from rgqa_tpu_torch.cli import compute_param

    counts = compute_param.main([])
    log("compute-param", f"trainable parameters: {counts}")
    if counts != PARAM_COUNTS:
        raise AssertionError(f"compute-param: {counts}, want {PARAM_COUNTS}")


def phase_slice19() -> None:
    """Phases 37-41 in one temporary directory (the 128-question root of
    phases 35-36), each timed."""
    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_weight_model_") as tmp:
        from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa

        root = os.path.join(tmp, "gqa")
        make_synthetic_gqa(root, SyntheticSpec(n_train=128, n_valid=32))
        timed("37 weight-model steps", phase_weight_model_steps, root)
        _, last = timed("38 weight-model CLI", phase_weight_model_cli, tmp, root)
        timed("39 distill CLI", phase_distill_cli, tmp, root, last)
        timed("40 verifier", phase_verifier, tmp, root, last)
        timed("41 compute_param", phase_compute_param)


# Phases 42-45: LXMERT pretraining, the VQA task and NLVR2 (slice 21).
PRETRAIN_BATCH = 256  # scripts/lxmert/train/pretrain.sh's batch
# Launches a pretraining step: the six losses read the language stream (the
# masked LM, and through the pooled CLS the matched and QA heads) and the
# vision stream (the RoI heads), so every one of the 34 attention calls
# takes its backward (an RP step's answer head reads the language stream
# alone: BWD_PER_STEP).
PRETRAIN_LAUNCHES = {0.0: _launches(fused_attention=34, fused_attention_bwd=34),
                     RATE: _launches(fused_attention_dropout=34, fused_attention_dropout_bwd=34)}
# Dropout-off pretraining step, kernels vs plain versions, each of the six
# losses, relative: phase 8's bound.  Five are means over many terms (the
# masked tokens' 30522-way CE, 9216 RoIs' CE and SmoothL1, 256 rows' QA
# CE) of per-logit bf16 errors of either sign, as phase 8's BCE is; the
# matched CE is the mean over 256 rows of a 2-way CE (~0.69), whose two
# logits a random init's pooled features barely move.
PRETRAIN_LOSS_RTOL = LOSS_RTOL
NLVR2_BATCH = 32  # scripts' batch: 64 (sentence, image) rows through the encoder
VQA_ACC_TOL = 1e-3  # the card's f32 minival accuracy against the CPU's


def _pretrain_batch(b: int, seed: int) -> dict:
    """A full-width pretraining batch on the card: BERT-vocabulary text of
    4-20 tokens ([CLS] ... [SEP], padding after), 36 x 2048 RoIs, detector
    ids, QA answers over ``PRETRAIN_ANSWERS`` (a quarter -1)."""
    import numpy as np
    from rgqa_tpu_torch.data.batching import to_device
    from rgqa_tpu_torch.models.zoo import default_config, example_batch
    from rgqa_tpu_torch.tools.profile_forward import PRETRAIN_ANSWERS

    batch = _padded_text(example_batch(default_config(), b, seed=seed), seed=seed + 1)
    lengths = batch["input_mask"].sum(1)
    batch["input_ids"][np.arange(b), lengths - 1] = 102  # [SEP]
    rng = np.random.default_rng(seed + 2)
    batch.update(obj_id=rng.integers(0, 1600, (b, 36)).astype(np.int32),
                 attr_id=rng.integers(0, 400, (b, 36)).astype(np.int32),
                 ans=np.where(rng.random(b) < 0.25, -1, rng.integers(0, PRETRAIN_ANSWERS, b)).astype(np.int32))
    return to_device(batch, "cuda")


def _pretrain_model(dropout: float):
    import torch
    from rgqa_tpu_torch.models.lxmert import LxmertPretraining
    from rgqa_tpu_torch.models.zoo import default_config, init_weights
    from rgqa_tpu_torch.tools.profile_forward import PRETRAIN_ANSWERS

    enc = dataclasses.replace(default_config().encoder, hidden_dropout=dropout, attention_dropout=dropout)
    with torch.device("cuda"):
        model = LxmertPretraining(enc, PRETRAIN_ANSWERS, dtype=torch.bfloat16)
    init_weights(model, torch.Generator(device="cuda").manual_seed(0))
    return model


def _pretrain_step(model, init, use_fused, steps: int = 1):
    import torch
    from rgqa_tpu_torch.config import OptimConfig
    from rgqa_tpu_torch.ops.dropout import DropoutRng
    from rgqa_tpu_torch.pretrain.trainer import make_pretrain_step
    from rgqa_tpu_torch.tools.profile_forward import BERT_MASK, BERT_SPECIALS
    from rgqa_tpu_torch.train.optimizer import make_optimizer

    model.load_state_dict(init)
    opt = make_optimizer(OptimConfig(lr=1e-4), model.parameters(), t_total=100)
    rng = DropoutRng(device=torch.Generator(device="cuda").manual_seed(1), host=torch.Generator().manual_seed(1))
    step, _ = make_pretrain_step(model, opt, mask_id=BERT_MASK, special_ids=BERT_SPECIALS, rng=rng,
                                 use_fused=use_fused)
    return step


def phase_pretrain_steps() -> None:
    """Phase 42: the pretraining step at full width (``LxmertPretraining``,
    9 / 5 / 5 x 768, vocab 30522, 9500 answers; f32 masters, bf16
    compute), batch 256, all six tasks, one set of host-drawn masks: at
    dropout 0 one step through the kernels and one through the plain
    versions from one init (the six losses within ``PRETRAIN_LOSS_RTOL``,
    launches ``PRETRAIN_LAUNCHES``); at dropout 0.1 launches a step, the
    wall over 4 steps and the device time a step (``torch.profiler``)."""
    import torch
    from rgqa_tpu_torch.pretrain import draw_pretrain_masks
    from rgqa_tpu_torch.pretrain.trainer import ALL_TASKS
    from rgqa_tpu_torch.tools.profile_forward import _device_time

    phase = "pretrain-steps"
    batch = _pretrain_batch(PRETRAIN_BATCH, seed=50)
    draws = draw_pretrain_masks(batch, ALL_TASKS, vocab_size=30522, generator=torch.Generator().manual_seed(2))
    counts = {}
    for dropout in (0.0, RATE):
        model = _pretrain_model(dropout)
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        step = _pretrain_step(model, init, None)
        reset_counts()
        parts = {k: float(v) for k, v in step(batch, draws).items()}
        torch.cuda.synchronize()
        counts[dropout] = read_counts()
        if dropout == 0.0:
            plain = {k: float(v) for k, v in _pretrain_step(model, init, False)(batch, draws).items()}
            if read_counts() != counts[dropout]:
                raise AssertionError(f"{phase}: the plain step launched a kernel")
            rel = {k: abs(parts[k] - plain[k]) / abs(plain[k]) for k in parts}
            log(phase, f"dropout 0, batch {PRETRAIN_BATCH}, one step from one init and one set of masks: losses "
                f"kernels {parts}, plain {plain}; relative gaps {rel} (bound {PRETRAIN_LOSS_RTOL:.0e}); launches "
                f"{_shown(counts[dropout])}")
            if list(parts) != list(ALL_TASKS) or not all(math.isfinite(v) for v in [*parts.values(), *plain.values()]):
                raise AssertionError(f"{phase}: losses {parts} / {plain}")
            if max(rel.values()) > PRETRAIN_LOSS_RTOL:
                raise AssertionError(f"{phase}: kernel and plain losses differ by {rel}")
        else:
            for _ in range(2):  # warm-up
                step(batch, draws)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(4):
                step(batch, draws)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 4
            classes = _device_time(lambda: step(batch, draws), 2)
            device_ms = sum(ms for ms, _ in classes.values())
            top = ", ".join(f"{c} {ms:.3f}" for c, (ms, _) in sorted(classes.items(), key=lambda kv: -kv[1][0])[:6])
            log(phase, f"dropout {RATE}: losses {parts}; launches a step {_shown(counts[dropout])}; device "
                f"{device_ms:.3f} ms a step ({top}), wall {wall:.3f} ms (before the profile), idle share "
                f"{1 - device_ms / wall:.4f}; {PRETRAIN_BATCH * 1e3 / wall:.1f} rows/s")
            if not all(math.isfinite(v) for v in parts.values()):
                raise AssertionError(f"{phase}: non-finite dropout losses {parts}")
        if counts[dropout] != PRETRAIN_LAUNCHES[dropout]:
            raise AssertionError(f"{phase}: launches a step at dropout {dropout} {counts[dropout]}, want "
                                 f"{PRETRAIN_LAUNCHES[dropout]}")
        del model, init, step
        torch.cuda.empty_cache()


def phase_pretrain_cli(tmp: str) -> str:
    """Phase 43: ``python -m rgqa_tpu_torch.cli.pretrain`` on a synthetic
    root at full width, one epoch, batch 32, all tasks (dropout 0.1): 34
    launches of #4 and of #5 a step, 34 of #1 an eval batch and none else,
    finite eval losses, ``BEST_EVAL_LOSS_LXRT.pth`` and
    ``Epoch00_LXRT.pth`` written, complete reference files.  Returns the
    output directory."""
    import torch
    from rgqa_tpu_torch.checkpoint.convert import load_reference_pth
    from rgqa_tpu_torch.cli import pretrain
    from rgqa_tpu_torch.data.dataset import GQADataset

    phase = "pretrain-cli"
    root, out = os.path.join(tmp, "gqa"), os.path.join(tmp, "pretrain")
    # scripts/lxmert/train/pretrain.sh's flags (all six tasks), one epoch at batch 32.
    argv = ["--synthetic", "--data_root", root, "--taskMaskLM", "--taskMatched", "--taskObjPredict", "--taskQA",
            "--visualLosses", "obj,attr,feat", "--epochs", "1", "--batchSize", "32", "--lr", "1e-4",
            "--output", out]
    reset_counts()
    t0 = time.perf_counter()
    history = pretrain.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    steps = len(GQADataset(root, "train")) // 32
    evals = len(GQADataset(root, "valid")) // 32
    want = _launches(fused_attention=34 * evals, fused_attention_dropout=34 * steps,
                     fused_attention_dropout_bwd=34 * steps)
    log(phase, f"pretrain CLI ({' '.join(argv)}) in {seconds:.2f} s: {steps} steps, {evals} eval batches, history "
        f"{history}; launches {_shown(launches)}")
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, want {want}")
    if not history["eval"] or not all(math.isfinite(x) for x in history["eval"]):
        raise AssertionError(f"{phase}: eval losses {history['eval']}")
    for name in ("BEST_EVAL_LOSS_LXRT.pth", "Epoch00_LXRT.pth"):
        _, missing, unused = load_reference_pth(os.path.join(out, name), backbone="lxmert_pretrain")
        if missing or unused:
            raise AssertionError(f"{phase}: {name} missing {missing[:3]}, unused {unused[:3]}")
    torch.cuda.empty_cache()
    return out


def _vqa_cli(phase, argv, want_launches=None) -> tuple:
    """``cli.vqa.main(argv)`` with its printed lines and its launches."""
    import contextlib
    import io

    import torch
    from rgqa_tpu_torch.cli import vqa

    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = vqa.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    lines = out.getvalue().strip().splitlines()
    log(phase, f"vqa CLI ({' '.join(argv)}) in {seconds:.2f} s: {lines[-1]}; launches {_shown(launches)}")
    if want_launches is not None and launches != want_launches:
        raise AssertionError(f"{phase}: launches {launches}, want {want_launches}")
    return result, lines


def _vqa_dump(path: str, n: int) -> list:
    with open(path) as f:
        rows = json.load(f)
    if len(rows) != n or not all(isinstance(r["question_id"], int) and isinstance(r["answer"], str) for r in rows):
        raise AssertionError(f"vqa-cli: {path} holds {len(rows)} rows, want {n} with integer ids")
    return rows


def phase_vqa_cli(tmp: str, pretrained: str) -> None:
    """Phase 44: ``python -m rgqa_tpu_torch.cli.vqa`` at full width on a
    synthetic VQA root: ``--train train,nominival --valid minival
    --batchSize 32 --epochs 1 --loadLXMERTQA <phase 43>/BEST_EVAL_LOSS``
    (answer rows transplanted through an ``all_ans.json`` of the
    pretraining answers), 34 #4 and 32 #5 a step and 34 #1 a validation
    forward; then ``--test minival --load BEST.pth --fp32`` on the card
    and with ``--device cpu`` (accuracies within ``VQA_ACC_TOL``, 34 #1 a
    forward on the card), and ``--test test`` (predict-only): each dump
    valid JSON with one integer-id row per question."""
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.data.synthetic import make_synthetic_vqa
    from rgqa_tpu_torch.pretrain import AnswerTable

    phase = "vqa-cli"
    root, out = os.path.join(tmp, "vqa"), os.path.join(tmp, "vqa_snap")
    make_synthetic_vqa(root)
    with open(os.path.join(tmp, "gqa", "trainval_label2ans.json")) as f:
        table = json.load(f)  # the pretraining run's answer table: the GQA root's vocabulary
    with open(os.path.join(root, "all_ans.json"), "w") as f:
        json.dump([{"ans": a, "dsets": ["gqa"]} for a in table], f)
    with open(os.path.join(root, "trainval_label2ans.json")) as f:
        answers = json.load(f)
    loaded = sum(AnswerTable.convert_ans(a) in set(table) for a in answers)
    n = {s: len(GQADataset(root, s)) for s in ("train,nominival", "minival", "test")}
    steps, forwards = n["train,nominival"] // 32, math.ceil(n["minival"] / 32)
    # scripts/vqa/train/vanilla.sh's flags, one epoch.
    argv = ["--synthetic", "--data_root", root, "--train", "train,nominival", "--valid", "minival", "--batchSize",
            "32", "--epochs", "1", "--lr", "5e-5", "--loadLXMERTQA", os.path.join(pretrained, "BEST_EVAL_LOSS"),
            "--output", out]
    history, lines = _vqa_cli(phase, argv, _launches(
        fused_attention=34 * forwards, fused_attention_dropout=34 * steps,
        fused_attention_dropout_bwd=BWD_PER_STEP * steps))
    line = f"Loaded {loaded} answers from LXRTQA pre-training and {len(answers) - loaded} not"
    if line not in lines or not any(l.startswith("Valid Oracle: ") for l in lines):
        raise AssertionError(f"{phase}: printed {lines[:4]}, want {line!r} and the oracle line")
    if not all(math.isfinite(x) for x in history["loss"]) or not os.path.isfile(os.path.join(out, "BEST.pth")):
        raise AssertionError(f"{phase}: history {history}, BEST.pth written: "
                             f"{os.path.isfile(os.path.join(out, 'BEST.pth'))}")
    best = os.path.join(out, "BEST.pth")
    accs = {}
    for device in ("cuda", "cpu"):
        test_out = os.path.join(tmp, f"vqa_minival_{device}")
        argv = ["--data_root", root, "--test", "minival", "--load", best, "--fp32", "--batchSize", "32",
                "--output", test_out, "--device", device]
        want = _launches(fused_attention=34 * forwards) if device == "cuda" else _launches()
        _, lines = _vqa_cli(phase, argv, want)
        accs[device] = json.loads(lines[-1])["accuracy"]
        rows = _vqa_dump(os.path.join(test_out, "minival_predict.json"), n["minival"])
        accs[f"{device} answers"] = {r["question_id"]: r["answer"] for r in rows}
    same = sum(accs["cuda answers"][q] == a for q, a in accs["cpu answers"].items())
    log(phase, f"minival accuracy, f32: card {accs['cuda']}, CPU {accs['cpu']} (bound {VQA_ACC_TOL}); "
        f"{same} of {n['minival']} answers equal")
    if abs(accs["cuda"] - accs["cpu"]) > VQA_ACC_TOL:
        raise AssertionError(f"{phase}: the card's minival accuracy {accs['cuda']} vs the CPU's {accs['cpu']}")
    test_out = os.path.join(tmp, "vqa_test")
    _, lines = _vqa_cli(phase, ["--data_root", root, "--test", "test", "--load", best, "--batchSize", "32",
                                "--output", test_out],
                        _launches(fused_attention=34 * math.ceil(n["test"] / 32)))
    if json.loads(lines[-1]) != {"split": "test", "dumped": True}:
        raise AssertionError(f"{phase}: --test test printed {lines[-1]}")
    _vqa_dump(os.path.join(test_out, "test_predict.json"), n["test"])


def phase_nlvr2(tmp: str) -> None:
    """Phase 45: ``Nlvr2Runner`` at full width (LXMERT 9 / 5 / 5 x 768 over
    two images a sentence, bf16 over f32 weights), batch 32 (64 encoder
    rows), one epoch on 128 synthetic pairs (34 #4 and 32 #5 a step, 34
    #1 a forward of the validation), then ``evaluate`` and ``dump_csv``
    (34 #1 a forward, none else; one line a pair); one validation batch's
    logits in f32 through the kernels and through the plain versions
    (the trained weights in an f32 copy) within ``LOGIT_TOL``."""
    import torch
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.data.synthetic import make_synthetic_gqa
    from rgqa_tpu_torch.models.nlvr2 import Nlvr2Model
    from rgqa_tpu_torch.nlvr2_task import Nlvr2Runner
    from rgqa_tpu_torch.tools.ddp_check import nlvr2_rows

    phase = "nlvr2"
    root = os.path.join(tmp, "gqa")
    if not os.path.isdir(root):
        make_synthetic_gqa(root)
    splits = {"train": nlvr2_rows(root, "train", 128, 0), "valid": nlvr2_rows(root, "valid", 64, 1)}
    cfg, _ = parse_cli(["--data_root", root, "--batchSize", str(NLVR2_BATCH), "--epochs", "1", "--lr", "5e-5",
                        "--output", os.path.join(tmp, "nlvr2")])  # the reference NLVR2 fine-tune's lr
    runner = Nlvr2Runner(cfg, splits)
    steps, forwards = 128 // NLVR2_BATCH, math.ceil(64 / NLVR2_BATCH)
    reset_counts()
    t0 = time.perf_counter()
    history = runner.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    want = _launches(fused_attention=34 * forwards, fused_attention_dropout=34 * steps,
                     fused_attention_dropout_bwd=BWD_PER_STEP * steps)
    log(phase, f"train, {steps} steps of {NLVR2_BATCH} pairs ({2 * NLVR2_BATCH} encoder rows), one validation, "
        f"in {seconds:.2f} s: history {history}; launches {_shown(launches)}")
    if launches != want or not all(math.isfinite(x) for x in history["loss"]):
        raise AssertionError(f"{phase}: launches {launches}, want {want}; history {history}")
    reset_counts()
    acc = runner.evaluate("valid")
    csv = os.path.join(tmp, "nlvr2", "valid.csv")
    runner.dump_csv("valid", csv)
    launches = read_counts()
    with open(csv) as f:
        lines = f.read().splitlines()
    log(phase, f"evaluate: accuracy {acc}; dump_csv {len(lines)} lines ({lines[0]!r}); launches {_shown(launches)}")
    if launches != _launches(fused_attention=2 * 34 * forwards):
        raise AssertionError(f"{phase}: evaluate + dump_csv launched {launches}")
    if len(lines) != 64 or {l.split(",")[1] for l in lines} - {"True", "False"} or not 0 <= acc <= 1:
        raise AssertionError(f"{phase}: dump {lines[:2]}, accuracy {acc}")
    with torch.device("cuda"):
        f32 = Nlvr2Model(cfg.model.encoder, torch.float32)
    f32.load_state_dict(runner.model.state_dict())
    f32.eval()
    _, batch, _ = next(iter(runner._batches(runner.splits["valid"], NLVR2_BATCH)))
    args = [batch[k] for k in ("input_ids", "input_mask", "segment_ids", "feats", "boxes")]
    with torch.inference_mode():
        reset_counts()
        kernel = f32(*args)["logits"]
        torch.cuda.synchronize()
        counted = read_counts()
        plain = f32(*args, use_fused=False)["logits"]
    gap = float((kernel - plain).abs().max())
    log(phase, f"one validation batch in f32: max |logits kernels - plain| {gap:.3e} (bound {LOGIT_TOL}); "
        f"launches {_shown(counted)}")
    if gap > LOGIT_TOL or counted != _launches(fused_attention=34):
        raise AssertionError(f"{phase}: f32 logits differ by {gap}, launches {counted}")
    del runner, f32
    torch.cuda.empty_cache()


def phase_slice21() -> None:
    """Phases 42-45 in one temporary directory, each timed."""
    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_pretrain_vqa_") as tmp:
        timed("42 pretrain steps", phase_pretrain_steps)
        pretrained = timed("43 pretrain CLI", phase_pretrain_cli, tmp)
        timed("44 vqa CLI", phase_vqa_cli, tmp, pretrained)
        timed("45 nlvr2", phase_nlvr2, tmp)


# Data parallel (phases 46-48).  The card machine has one card and NCCL
# takes one rank a card: (a) the train CLI under torchrun at world 1 on
# NCCL, (b)-(c) two gloo ranks on cuda:0 through tools/ddp_check.py, each
# against one process at the same global batch.  The torchrun run and the
# two ranks start first and run beside this process's one-process runs.
DP_SPEC = "64,96,32,64"  # the roots' images / train / valid / testdev rows: 3 RP steps of 32, 2 pretraining of 64
DP_ENTRY_PATHS = ("serve", "distill_mc", "distill_ensemble", "verifier")  # phase 49, held to one process
DP_DROP_PATHS = ("distill_mc_drop", "verifier_drop")  # phase 49 at dropout 0.1: each rank its own stream
DP_PATHS = ",".join(("rp", "mixup_v1", "pretrain", "eval_msp", "eval_maha", "rp_drop", *DP_ENTRY_PATHS,
                     *DP_DROP_PATHS))
NCCL_RTOL = 1e-6  # torchrun at world 1 against one process (or the noise floor of two one-process runs)
DP_RTOL = 1e-4  # two ranks against one process, f32; also the maha fit's moments
DP_CONF_TOL = 1e-5  # the evaluate paths' confidences, two ranks against one process
DP_MAHA_FLOOR = 2.0  # maha's confidences: ranks within this x one process's own batch-16-vs-32 gap
RP_STEP = _launches(fused_attention=34, fused_attention_bwd=BWD_PER_STEP)  # dropout 0, per rank


def _train_cli_rank(argv: list) -> None:
    """Child mode of phase 46 (``chip_smoke.py --train-cli-rank ARGV``, run
    by torchrun): the train CLI's ``main`` with every step recorded; one
    ``TRAIN_CLI {json}`` line."""
    import torch
    import torch.distributed as dist
    from rgqa_tpu_torch.cli import train as train_cli
    from rgqa_tpu_torch.tools.ddp_check import Recorder, recording

    rec = Recorder(torch.device("cuda"))
    with recording(rec):
        history = train_cli.main(argv)
    print("TRAIN_CLI " + json.dumps({"steps": rec.steps, "history": history, "world": dist.get_world_size(),
                                     "backend": str(dist.get_backend())}), flush=True)
    dist.destroy_process_group()


def _recorded_cli(argv: list) -> dict:
    """``cli.train.main(argv)`` in this process, every step recorded."""
    import torch
    from rgqa_tpu_torch.cli import train as train_cli
    from rgqa_tpu_torch.tools.ddp_check import Recorder, recording

    rec = Recorder(torch.device("cuda"))
    with recording(rec):
        history = train_cli.main(argv)
    return {"steps": rec.steps, "history": history}


def _same_counts(got: dict, want: dict) -> bool:
    """Equal launch counts, a kernel absent from one dict counting 0."""
    return all(got.get(k, 0) == want.get(k, 0) for k in set(got) | set(want))


def _step_losses(record: dict) -> list:
    out = []
    for step in record["steps"]:
        loss = step["loss"]
        out.extend(loss.values() if isinstance(loss, dict) else [loss])
    return out


def _max_rel(got, want) -> float:
    return max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, want))


def _start_torchrun(tmp: str):
    """Phase 46's root, its train CLI arguments, and its run under
    ``python -m torch.distributed.run --nproc_per_node 1`` started (the
    output to files, read once it ends)."""
    from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa

    n_images, n_train, n_valid, n_testdev = (int(x) for x in DP_SPEC.split(","))
    root = os.path.join(tmp, "nccl_gqa")
    make_synthetic_gqa(root, SyntheticSpec(n_images=n_images, n_train=n_train, n_valid=n_valid,
                                           n_testdev=n_testdev, seed=3))
    argv = ["--data_root", root, "--sample_pair", "--epochs", "1", "--batchSize", "32"]
    out, err = (open(os.path.join(tmp, f"torchrun.{k}"), "w+") for k in ("out", "err"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nnodes", "1", "--nproc_per_node", "1",
         os.path.abspath(__file__),
         "--train-cli-rank", *argv, "--output", os.path.join(tmp, "nccl_torchrun")],
        stdout=out, stderr=err, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__))))
    return argv, proc, (out, err), time.perf_counter()


def phase_nccl_world1(tmp: str, started) -> None:
    """Phase 46: the train CLI at full width (9 / 5 / 5 x 768, 36 x 2048
    RoIs, bf16), batch 32, one epoch of 3 RP steps at dropout 0.1, under
    ``python -m torch.distributed.run --nproc_per_node 1`` (NCCL, world 1;
    ``started`` by :func:`_start_torchrun`) and twice without torchrun in
    this process: the torchrun run's step losses within ``NCCL_RTOL`` of
    the first (or of the two one-process runs' own spread, the card's
    floor, where that is larger), 34 #4 and 32 #5 a step."""
    phase = "dp-nccl"
    argv, proc, (out, err), t0 = started
    n_train = int(DP_SPEC.split(",")[1])
    try:
        runs, walls = [], []
        for i in range(2):
            t1 = time.perf_counter()
            runs.append(_recorded_cli([*argv, "--output", os.path.join(tmp, f"nccl_one_{i}")]))
            walls.append(time.perf_counter() - t1)
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    walls.append(time.perf_counter() - t0)
    with out, err:
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
    line = next((l for l in stdout.splitlines() if l.startswith("TRAIN_CLI ")), None)
    if proc.returncode != 0 or line is None:
        raise AssertionError(f"{phase}: torchrun exited {proc.returncode}:\n{stdout[-2000:]}\n{stderr[-4000:]}")
    ranked = json.loads(line[len("TRAIN_CLI "):])
    one, again, tr = (_step_losses(r) for r in (*runs, ranked))
    floor = _max_rel(again, one)
    gap = _max_rel(tr, one)
    log(phase, f"step losses, one process: {one}; again: {again} (max rel {floor:.3e}, the floor); torchrun "
        f"world {ranked['world']} on {ranked['backend']}: {tr} (max rel {gap:.3e}, bound "
        f"{max(NCCL_RTOL, floor):.1e}); walls {walls[0]:.1f} s, {walls[1]:.1f} s one process, {walls[2]:.1f} s "
        f"torchrun (the torchrun run and phases 47-48's two ranks beside them)")
    want = _launches(fused_attention_dropout=34, fused_attention_dropout_bwd=BWD_PER_STEP)
    for name, record in (("one process", runs[0]), ("torchrun", ranked)):
        per_step = [step["launches"] for step in record["steps"]]
        log(phase, f"{name}: launches a step {_shown(per_step[0])}; step times (CUDA events) "
            f"{[step['ms'] and round(step['ms'], 2) for step in record['steps']]} ms")
        if len(per_step) != n_train // 32 or not all(_same_counts(l, want) for l in per_step):
            raise AssertionError(f"{phase}: {name} launched {per_step}, want {want} a step")
    if ranked["world"] != 1 or ranked["backend"] != "nccl" or len(tr) != len(one):
        raise AssertionError(f"{phase}: torchrun ran world {ranked['world']} on {ranked['backend']}, {len(tr)} steps")
    if gap > max(NCCL_RTOL, floor) or not all(math.isfinite(x) for x in tr):
        raise AssertionError(f"{phase}: torchrun's losses {tr} vs {one}: max rel {gap}")


def _moment_gaps(got: str, want: str) -> tuple[bool, float, float, tuple]:
    """Two fits' moments (``ddp_check``'s ``maha_moments.pt``): whether
    the counts are equal, the sums' and the second moment's largest
    difference over their largest entry, and the eigenvalues of the
    covariance of ``want`` (largest, smallest, the count below 1e-6 of
    the largest)."""
    import numpy as np
    import torch

    (gs, gc, g2), (ws, wc, w2) = (torch.load(p, weights_only=True) for p in (got, want))

    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    counts = wc.double().numpy()
    mean = ws.double().numpy() / np.maximum(counts, 1.0)[:, None]
    cov = (w2.double().numpy() - (counts[:, None] * mean).T @ mean) / max(counts.sum(), 1.0)
    ev = np.linalg.eigvalsh(cov)
    return bool(torch.equal(gc, wc)), rel(gs, ws), rel(g2, w2), (ev[-1], ev[0], int((ev < 1e-6 * ev[-1]).sum()))


def phase_two_ranks(tmp: str, argv: list, spawn, t0: float) -> None:
    """Phases 47-48: two gloo ranks on cuda:0 (``tools/ddp_check.py``, both
    ranks on the one card; gloo's collectives staged through pinned host
    memory; ``spawn`` the future of their :func:`ddp_check.launch`,
    started at ``t0``) against one process at the same global batch, f32,
    full width, dropout 0: 3 RP and 3 ``mixup_v1`` steps of 32 (16 a
    rank), 2 pretraining steps of 64, all six tasks; the evaluate CLI
    with ``--scorer msp`` and ``--scorer maha``; RP at dropout 0.1.
    Losses within ``DP_RTOL`` (pretraining ``PRETRAIN_LOSS_RTOL``), the
    dumps' ids and answers equal and the confidences within
    ``DP_CONF_TOL``; per rank 34 #1 / 32 #3 an RP step and 34 / 34 a
    pretraining step; at dropout 0.1 the ranks' attention seeds differ and
    their shifts and batches agree.  Mahalanobis: the fit's moments (the
    gathered features' sums, counts and second moment) within
    ``DP_RTOL`` of one process's, the counts equal; its confidences pass
    through the covariance's inverse, whose small eigenvalues turn the
    forwards' batch-dependent round-off into ~1e-3, so they are held to
    ``DP_MAHA_FLOOR`` x the gap between one process scored at the rank's
    batch, 16, and at 32 (or ``DP_CONF_TOL``)."""
    import torch
    from rgqa_tpu_torch.tools import ddp_check

    phase = "dp-ranks"
    t1 = time.perf_counter()
    one = ddp_check.run(ddp_check._parser().parse_args([*argv, "--out", os.path.join(tmp, "dp_one")]))
    one_wall = time.perf_counter() - t1
    floor_out = os.path.join(tmp, "dp_floor")
    os.makedirs(os.path.join(floor_out, "rp"))
    shutil.copy(os.path.join(tmp, "dp_one", "rp", "INIT.pth"), os.path.join(floor_out, "rp", "INIT.pth"))
    floor_argv = [a if a != DP_PATHS else "eval_maha" for a in argv]
    floor_argv[floor_argv.index("--batch") + 1] = "16"
    floor = ddp_check.run(ddp_check._parser().parse_args([*floor_argv, "--out", floor_out]))["eval_maha"]
    two = [r["paths"] for r in spawn.result()]
    two_wall = time.perf_counter() - t0
    log(phase, f"one process {one_wall:.1f} s; two gloo ranks on cuda:0 {two_wall:.1f} s (both ranks' "
        f"processes, their start included, beside phase 46 and the one-process runs); seconds a path, one "
        f"process {({k: round(v['seconds'], 1) for k, v in one.items()})}, rank 0 "
        f"{({k: round(v['seconds'], 1) for k, v in two[0].items()})}")
    for path, bound, per_step in (("rp", DP_RTOL, RP_STEP), ("mixup_v1", DP_RTOL, RP_STEP),
                                  ("pretrain", PRETRAIN_LOSS_RTOL, PRETRAIN_LAUNCHES[0.0])):
        want = _step_losses(one[path])
        got = [_step_losses(r[path]) for r in two]
        gap = max(_max_rel(g, want) for g in got)
        times = {name: [s["ms"] and round(s["ms"], 2) for s in rec["steps"]]
                 for name, rec in (("one", one[path]), ("rank 0", two[0][path]), ("rank 1", two[1][path]))}
        launches = [[s["launches"] for s in r[path]["steps"]] for r in two]
        log(phase, f"{path}: {len(want)} losses, one process {want}; ranks max rel {gap:.3e} (bound {bound}); "
            f"step times (CUDA events, ms) {times}; launches a step per rank {_shown(launches[0][0])}")
        if gap > bound or got[0] != got[1] or not all(math.isfinite(x) for x in want):
            raise AssertionError(f"{phase}: {path} losses {got} vs {want}")
        if not all(_same_counts(l, per_step) for rank in launches for l in rank):
            raise AssertionError(f"{phase}: {path} launched {launches}, want {per_step} a step on each rank")

    def rel_gap(a, b) -> float:
        return max(abs(x[2] - y[2]) / max(abs(y[2]), 1e-12) for x, y in zip(a["scores"], b["scores"]))

    counts_equal, sums_rel, second_rel, (ev_max, ev_min, n_small) = _moment_gaps(
        two[0]["eval_maha"]["moments"], one["eval_maha"]["moments"])
    log(phase, f"eval_maha fit: counts equal {counts_equal}; sums max rel {sums_rel:.3e}, second moment "
        f"{second_rel:.3e} (bound {DP_RTOL}); one process's covariance: eigenvalues {ev_max:.3e} to "
        f"{ev_min:.3e}, {n_small} below 1e-6 of the largest")
    if not counts_equal or max(sums_rel, second_rel) > DP_RTOL:
        raise AssertionError(f"{phase}: eval_maha's fit differs from one process's")
    floor_rel = rel_gap(floor, one["eval_maha"])
    for path in ("eval_msp", "eval_maha"):
        want, got = one[path], two[0][path]
        same = [row[:2] for row in got["dump"]] == [row[:2] for row in want["dump"]]
        gap = max(abs(a[2] - b[2]) for a, b in zip(got["scores"], want["scores"]))
        rel = rel_gap(got, want)
        bound = DP_CONF_TOL if path == "eval_msp" else max(DP_CONF_TOL, DP_MAHA_FLOOR * floor_rel)
        dump_gap = max(abs(a[2] - b[2]) for a, b in zip(got["dump"], want["dump"]))
        log(phase, f"{path}: {len(got['dump'])} rows, ids and answers as one process: {same}; confidences max "
            f"|d| {gap:.3e} (rel {rel:.3e}; dump {dump_gap:.1e}; bound {bound:.3e}"
            + (f": one process at batch 16 against 32 rel {floor_rel:.3e}" if path == "eval_maha" else "")
            + f"); launches rank 0 {_shown(got['launches'])}, one process {_shown(want['launches'])}")
        if not same or rel > bound or [r[:2] for r in got["scores"]] != [r[:2] for r in want["scores"]]:
            raise AssertionError(f"{phase}: {path} differs from one process")
    d0, d1 = two[0]["rp_drop"], two[1]["rp_drop"]
    log(phase, f"rp at dropout 0.1: shifts {d0['shifts']} / {d1['shifts']}; first seeds {d0['seeds'][:2]} / "
        f"{d1['seeds'][:2]} ({len(d0['seeds'])} a rank); losses {_step_losses(d0)}")
    if d0["shifts"] != d1["shifts"] or d0["qids"] != d1["qids"] or any(
            a == b for a, b in zip(d0["seeds"], d1["seeds"])) or not d0["seeds"]:
        raise AssertionError(f"{phase}: dropout streams: shifts {d0['shifts']} / {d1['shifts']}, seeds alike")
    torch.cuda.empty_cache()
    return one, two


def _start_serve_torchrun(tmp: str, argv: list, init: str, started: dict) -> None:
    """Phase 49's serve under ``python -m torch.distributed.run
    --standalone --nproc_per_node 1`` (NCCL, world 1), started once
    ``init`` (the one-process run's ``rp/INIT.pth``) is whole: the serve
    path's arguments and records (``ddp_check.serve_argv`` /
    ``serve_records``) on stdin, its output to files."""
    from rgqa_tpu_torch.tools import ddp_check

    args = ddp_check._parser().parse_args([*argv, "--out", os.path.join(tmp, "dp_one")])
    root = os.path.join(args.root, "gqa")
    records = os.path.join(tmp, "serve_records.jsonl")
    with open(records, "w") as f:
        f.write("".join(line + "\n" for line in ddp_check.serve_records(root)))
    deadline = time.monotonic() + 300
    while not os.path.isfile(init) and time.monotonic() < deadline:
        time.sleep(0.2)
    out, err = (open(os.path.join(tmp, f"serve_torchrun.{k}"), "w+") for k in ("out", "err"))
    with open(records) as stdin:
        started["proc"] = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nnodes", "1", "--nproc_per_node",
             "1", "-m", "rgqa_tpu_torch.cli.serve",
             *ddp_check.serve_argv(args, root, os.path.join(tmp, "serve_torchrun")), "--device", "cuda"],
            stdin=stdin, stdout=out, stderr=err, text=True,
            env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__))))
    started["files"] = (out, err)


def _answers(lines: list) -> tuple[list, list]:
    rows = [json.loads(line) for line in lines]
    return [r for r in rows if "error" not in r], [r for r in rows if "error" in r]


def phase_dp_entry_points(one: dict, two: list, started: dict) -> None:
    """Phase 49: the serve CLI, the distill CLI (cartography over two
    passes; two ensemble teachers) and the verifier (an epoch of training,
    then its evaluation) on phase 47's two gloo ranks on cuda:0 against
    one process, full width, f32, global batch 32: the serve's answers
    and its two error lines as one process's, printed on rank 0 alone,
    its printed confidences within one unit of the fourth decimal and the
    unrounded ones within ``DP_CONF_TOL``; the distilled rows' ids and
    labels equal and their scores within ``DP_CONF_TOL``; the verifier's
    step losses within ``DP_RTOL`` and its confidences within
    ``DP_CONF_TOL``; every path's launches alike on both ranks, nonzero.
    At dropout 0.1 (``DP_DROP_PATHS``) the MC passes and the verifier's
    steps run #4 (and #5), the ranks' results alike.  Then the serve
    under torchrun at world 1 on NCCL
    (:func:`_start_serve_torchrun`) prints the one-process serve's lines
    byte for byte."""
    phase = "dp-entry"
    for path in DP_ENTRY_PATHS:
        o, r0, r1 = one[path], two[0][path], two[1][path]
        launches = [r0["launches"], r1["launches"]]
        msg = f"{path}: seconds one process {o['seconds']:.1f}, rank 0 {r0['seconds']:.1f}; launches per rank " \
              f"{[_shown(l) for l in launches]}"
        if path == "verifier":
            launches += [r0["train_launches"], r1["train_launches"]]
            msg += f", training {[_shown(l) for l in launches[2:]]}"
        if launches[0] != launches[1] or not any(launches[0].values()) or (len(launches) > 2 and (
                launches[2] != launches[3] or not any(launches[2].values()))):
            raise AssertionError(f"{phase}: {msg}: the ranks' launches differ or are none")
        if path == "serve":
            answers, errors = _answers(r0["lines"])
            want, want_errors = _answers(o["lines"])
            same = [(a["questionId"], a["prediction"]) for a in answers] == [
                (a["questionId"], a["prediction"]) for a in want]
            printed = max(abs(a["confidence"] - b["confidence"]) for a, b in zip(answers, want))
            rel = max(abs(a[1] - b[1]) / max(abs(b[1]), 1e-12) for a, b in zip(r0["scores"], o["scores"]))
            log(phase, f"{msg}; {len(answers)} answers as one process's: {same}; printed confidences max |d| "
                f"{printed:.1e}, unrounded max rel {rel:.3e} (bound {DP_CONF_TOL})")
            if (not same or errors != want_errors or len(errors) != 2 or r1["lines"] or printed > 1e-4 + 1e-9
                    or rel > DP_CONF_TOL or [a[0] for a in r1["scores"]] != [a[0] for a in o["scores"]]):
                raise AssertionError(f"{phase}: serve differs from one process")
        elif path.startswith("distill"):
            def key(rows):
                return [(r["question_id"], r["img_id"], list(r["label"])) for r in rows]

            def scores(rows):
                return [v for r in rows for v in r["label"].values()]

            rel = max((abs(a - b) / max(abs(b), 1e-12) for a, b in zip(scores(r0["rows"]), scores(o["rows"]))),
                      default=0.0)
            log(phase, f"{msg}; {len(o['rows'])} rows, ids and labels as one process's: "
                f"{key(r0['rows']) == key(o['rows'])}; scores max rel {rel:.3e} (bound {DP_CONF_TOL})")
            if (not o["rows"] or key(r0["rows"]) != key(o["rows"]) or key(r1["rows"]) != key(o["rows"])
                    or rel > DP_CONF_TOL or not r0["written"]):
                raise AssertionError(f"{phase}: {path} differs from one process")
        else:
            gap = _max_rel(r0["losses"], o["losses"])
            rel = max(abs(a[2] - b[2]) / max(abs(b[2]), 1e-12) for a, b in zip(r0["scores"], o["scores"]))
            log(phase, f"{msg}; {len(o['losses'])} step losses, one process {o['losses']}: ranks max rel "
                f"{gap:.3e} (bound {DP_RTOL}); {len(o['scores'])} confidences max rel {rel:.3e} (bound "
                f"{DP_CONF_TOL}); results {o['results']}")
            if (gap > DP_RTOL or r0["losses"] != r1["losses"] or rel > DP_CONF_TOL or not all(
                    math.isfinite(x) for x in o["losses"])
                    or [a[:2] for a in r0["scores"]] != [a[:2] for a in o["scores"]]):
                raise AssertionError(f"{phase}: verifier differs from one process")
    for path in DP_DROP_PATHS:  # each rank draws its own passes, all report the global result
        r0, r1 = two[0][path], two[1][path]
        kinds = [k for k in ("train_launches", "launches") if k in r0]
        key = "losses" if path == "verifier_drop" else "rows"
        log(phase, f"{path} at dropout 0.1: launches per rank {[[_shown(r[k]) for k in kinds] for r in (r0, r1)]}; "
            f"ranks agree: {r0[key] == r1[key]}" + (f"; losses {r0['losses']}" if key == "losses" else
                                                    f"; {len(r0['rows'])} rows"))
        if (r0[key] != r1[key] or not r0[key] or any(r0[k] != r1[k] for k in kinds)
                or not r0[kinds[0]].get("fused_attention_dropout")):
            raise AssertionError(f"{phase}: {path}: the ranks disagree or launched no #4")
    proc = started.get("proc")
    if proc is None:
        raise AssertionError(f"{phase}: the torchrun serve never started (no INIT.pth)")
    try:
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out, err = started["files"]
    with out, err:
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
    lines = [l for l in stdout.splitlines() if l.startswith("{")]
    log(phase, f"serve under torchrun (NCCL, world 1): exit {proc.returncode}, {len(lines)} lines, byte for byte "
        f"the one-process serve's: {lines == one['serve']['lines']}; {stderr.strip().splitlines()[-1:]}")
    if proc.returncode != 0 or lines != one["serve"]["lines"]:
        raise AssertionError(f"{phase}: torchrun serve exited {proc.returncode}:\n{stdout[-2000:]}\n{stderr[-3000:]}")


def phase_slice22() -> None:
    """Phases 46-48 in one temporary directory: the roots written, then
    the torchrun run and the two ranks started, and this process's
    one-process runs of both phases beside them, each phase timed."""
    import concurrent.futures

    from rgqa_tpu_torch.parallel import SINGLE
    from rgqa_tpu_torch.tools import ddp_check

    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_dp_") as tmp:
        argv = ["--device", "cuda:0", "--full", "--batch", "32", "--spec", DP_SPEC, "--paths", DP_PATHS,
                "--root", os.path.join(tmp, "dp_roots")]
        ddp_check._roots(ddp_check._parser().parse_args([*argv, "--out", tmp]), SINGLE)
        started = _start_torchrun(tmp)
        t0 = time.perf_counter()
        serve = {}
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            spawn = pool.submit(ddp_check.launch, 2, [*argv, "--out", os.path.join(tmp, "dp_two")],
                                env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__))))
            pool.submit(_start_serve_torchrun, tmp, argv, os.path.join(tmp, "dp_one", "rp", "INIT.pth"), serve)
            timed("46 torchrun NCCL world 1", phase_nccl_world1, tmp, started)
            one, two = timed("47-48 two gloo ranks", phase_two_ranks, tmp, argv, spawn, t0)
            timed("49 serve, distill and the verifier on two ranks", phase_dp_entry_points, one, two, serve)


# ---------------------------------------------------------------------------
# Phase 50: the recipe scripts through the port's CLIs.
# ---------------------------------------------------------------------------

RECIPE_PAIR = (("lxmert/train/vanilla.sh", ["--synthetic", "--epochs", "1"]),
               ("lxmert/test/msp.sh", ["--synthetic"]))
RGQA_SUBSETS = ("ClipEasy", "ClipHard", "PTEasy", "PTHard")


def phase_recipes() -> None:
    """Phase 50: ``python -m rgqa_tpu_torch.tools.recipes`` runs
    ``RECIPE_PAIR`` on the card, full width, on the default synthetic root
    (its ``GQAUQ_*`` splits): the vanilla train recipe for an epoch
    (``LAST.pth`` loads back with no key missing or unused), then the msp
    test recipe from it (``LOAD``) over the four RGQA testdev subsets,
    each a result with a finite AUAF and a dump of one row per
    question."""
    from rgqa_tpu_torch.checkpoint.convert import load_reference_pth
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.data.synthetic import make_synthetic_gqa

    phase = "recipes"
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_recipes_") as tmp:
        root, snap = os.path.join(tmp, "gqa"), os.path.join(tmp, "snap")
        make_synthetic_gqa(root)
        env = dict(os.environ, DATA_ROOT=root, OUTPUT=snap, LOAD=os.path.join(snap, "lxmert", "vanilla", "LAST"),
                   PYTHONPATH=here)
        for script, flags in RECIPE_PAIR:
            cmd = [sys.executable, "-m", "rgqa_tpu_torch.tools.recipes", os.path.join(here, "scripts", script), *flags]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
            log(phase, f"{' '.join(cmd[2:])}: exit {r.returncode} in {time.perf_counter() - t0:.1f} s; "
                f"{r.stdout.strip().splitlines()[-1:]}")
            if r.returncode != 0:
                raise AssertionError(f"{phase}: {script} exited {r.returncode}:\n{r.stdout[-2000:]}\n"
                                     f"{r.stderr[-3000:]}")
        _, missing, unused = load_reference_pth(os.path.join(snap, "lxmert", "vanilla", "LAST.pth"))
        if missing or unused:
            raise AssertionError(f"{phase}: LAST.pth missing {missing[:3]}, unused {unused[:3]}")
        results = {}
        for subset in RGQA_SUBSETS:
            split = f"GQAUQ_testdev_questions_{subset}"
            with open(os.path.join(snap, "lxmert", "msp", f"{split}_result.json")) as f:
                results[subset] = json.load(f)
            with open(os.path.join(snap, "lxmert", "msp", f"{split}_predict.json")) as f:
                rows = json.load(f)
            if not math.isfinite(results[subset]["auaf"]) or len(rows) != len(GQADataset(root, split, add_uq=True).data):
                raise AssertionError(f"{phase}: {split}: result {results[subset]}, {len(rows)} dumped rows")
        log(phase, f"LAST.pth loads back whole; AUAF by subset {({k: v['auaf'] for k, v in results.items()})}")


def _reachable_acc(root: str) -> float:
    """The accuracy (the acc-fpr curve's: correct over answerable) of
    answering testdev's most frequent answer to every question."""
    import collections

    from rgqa_tpu_torch.data.dataset import GQADataset

    golds = [next(iter(d["label"]), "UQ") for d in GQADataset(root, "testdev", add_uq=True).data]
    answerable = [g for g in golds if g != "UQ"]
    return collections.Counter(answerable).most_common(1)[0][1] / len(answerable)


# ---------------------------------------------------------------------------
# Phases 51-53 (slice 24): the long-stream dropout pair 4L / 5L, UNITER at a
# 40-token question (a 76-token stream), the dry-run entry.
# ---------------------------------------------------------------------------

UNITER_LONG_TEXT = 40  # BUTD's question length in the config: 40 + 36 RoIs = 76 tokens
UNITER_LONG = (UNITER_LONG_TEXT + 36,) * 2
# 4L / 5L against the plain pair: UNITER's 76 tokens at a training step's
# 32 and 64 rows, ViLT-B/32's streams and ragged query / key tiles, a
# 512 px image's 277 tokens and 16 px patches' 597.  (shape, batch).
DROP_LONG_CASES = ((UNITER_LONG, 32), (UNITER_LONG, 64), (UNITER_LONG, 256), ((165, 165), 256),
                   ((185, 185), 256), ((65, 185), 256), ((185, 65), 256), ((277, 277), 256), ((597, 597), 64))
DROP_LONG_MAIN = (UNITER_LONG, 32)  # the JSON line's shape: the UNITER-76 step's calls
# The f32 bodies are timed at UNITER-76's step and ViLT-B/32's 165 tokens.
DROP_LONG_F32_TIMED = ((UNITER_LONG, 32), ((165, 165), 256))
DROP_LONG_ITERS = 20  # calls a device-time profile


def _drop_long_readout(att, gen, s: int, dtype) -> str:
    """4L's mask at ``s`` x ``s``, batch 32, read through q = k = 0 (P =
    1 / s) and a one-hot V, 64 keys a call (a head holds 64 values):
    out[b, i, h*D + c] > 0 iff keep(b, h, i, 64 p + c).  Equal to
    ``dropout_keep_mask_ref`` bit for bit, kept fraction within 5 sigma."""
    import torch

    b, d = 32, E // HEADS
    zeros = torch.zeros(b, s, E, device="cuda", dtype=dtype)
    bias = torch.zeros(b, s, device="cuda")
    seed = int(torch.randint(0, 2**62, (), generator=gen, device="cuda"))
    got = torch.empty(b, HEADS, s, s, dtype=torch.bool, device="cuda")
    for j0 in range(0, s, d):
        n = min(d, s - j0)
        v = torch.zeros(b, s, HEADS, d, device="cuda", dtype=dtype)
        v[:, torch.arange(j0, j0 + n), :, torch.arange(n)] = 1.0
        out = att.fused_attention_dropout_long_cuda(zeros, zeros, v.reshape(b, s, E), bias, HEADS, RATE, seed)
        got[..., j0:j0 + n] = out.reshape(b, s, HEADS, d)[..., :n].permute(0, 2, 1, 3) > 0
    want = att.dropout_keep_mask_ref(seed, b, HEADS, s, s, RATE, device="cuda")
    if not torch.equal(got, want):
        raise AssertionError(f"4L's mask ({dtype}, {s}x{s}) differs from dropout_keep_mask_ref in "
                             f"{int((got != want).sum())} places")
    keep_p = (256 - round(RATE * 256)) / 256
    frac = got.float().mean().item()
    sigma = math.sqrt(keep_p * (1 - keep_p) / got.numel())
    if abs(frac - keep_p) >= 5 * sigma:
        raise AssertionError(f"4L's kept fraction {frac} is {abs(frac - keep_p) / sigma:.2f} sigma from {keep_p}")
    return (f"mask {str(dtype).split('.')[1]} {s}x{s} == dropout_keep_mask_ref, kept {frac:.6f} "
            f"({abs(frac - keep_p) / sigma:.2f} sigma)")


def phase_long_dropout_kernels():
    """Phase 51: 4L / 5L against the plain pair (``attention_dropout_ref`` /
    ``_bwd_ref``) at DROP_LONG_CASES, f32 and bf16, rate 0.1, padded-text
    masks with one fully masked row; 5L and #3L on both routes, the exact
    one (D by a sweep, dbias) and the one every model path runs
    (``dbias=False``: D from the forward's output, no dbias), dq / dk / dv
    against the plain pair's; rate 0 equal to #2 / #3L bit for bit on
    both routes (out, row statistics and gradients); ``<g, out> == <dv,
    v>`` in f32; two runs at 165 tokens equal bit for bit; the mask read
    out in both bodies of each dtype; per-call device times of 4L, 5L on
    both routes, #3L on the model's and SDPA with ``dropout_p``, the plain
    versions' by CUDA events, in bf16 at every shape and in f32 at
    DROP_LONG_F32_TIMED.  Returns (errs, times) as phase 3,
    the times keyed by label ("4L", "5L" the model's route, "5L dbias",
    "#3L")."""
    import torch
    from rgqa_tpu_torch.ops import attention as att
    from rgqa_tpu_torch.tools.time_attention import device_us

    def dev_ms(fn):
        """Device time per call; CUDA events where the profiler lost events
        three times (logged)."""
        us = device_us(fn, DROP_LONG_ITERS, match=None)
        if us is None:
            log("long-dropout", "the profiler lost device events three times: CUDA events instead")
            return cuda_ms(fn, iters=DROP_LONG_ITERS)
        return us * 1e-3

    gen = torch.Generator(device="cuda").manual_seed(2424)
    errs, times = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for (sq, skv), b in DROP_LONG_CASES:
            q, k, v, g, _ = _attention_inputs(b, sq, skv, dtype, gen)
            bias = (_uniter_bias(b, gen, UNITER_LONG_TEXT) if (sq, skv) == UNITER_LONG
                    else _pad_patch_bias(b, skv, gen))
            seed = int(torch.randint(0, 2**62, (), generator=gen, device="cuda"))
            out, lse = att.fused_attention_dropout_long_cuda(q, k, v, bias, HEADS, RATE, seed, lse=True)
            out2, lse2 = att.fused_attention_long_cuda(q, k, v, bias, HEADS, lse=True)
            plain_bwd = functools.lru_cache(None)(lambda: att.attention_dropout_bwd_ref(q, k, v, bias, g, HEADS,
                                                                                        RATE, seed))
            plain3 = functools.lru_cache(None)(lambda: att.attention_bwd_ref(q, k, v, bias, g, HEADS))
            # (label, kernel name, kernel, plain): the model's routes first.
            calls = (
                ("4L", "fused_attention_dropout_long",
                 lambda: att.fused_attention_dropout_long_cuda(q, k, v, bias, HEADS, RATE, seed),
                 lambda: att.attention_dropout_ref(q, k, v, bias, HEADS, RATE, seed)),
                ("5L", "fused_attention_dropout_long_bwd",
                 lambda: att.fused_attention_dropout_long_bwd_cuda(q, k, v, bias, g, HEADS, RATE, seed, lse,
                                                                   dbias=False, out=out), plain_bwd),
                ("5L dbias", "fused_attention_dropout_long_bwd",
                 lambda: att.fused_attention_dropout_long_bwd_cuda(q, k, v, bias, g, HEADS, RATE, seed, lse),
                 plain_bwd),
                ("#3L", "fused_attention_long_bwd",
                 lambda: att.fused_attention_long_bwd_cuda(q, k, v, bias, g, HEADS, lse2, dbias=False, out=out2),
                 plain3),
            )
            msgs = []
            for label, name, kernel, plain in calls:
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                if isinstance(got, tuple) and label != "5L dbias":
                    if got[3] is not None:
                        raise AssertionError(f"{label} without dbias returned a bias gradient")
                    got, want = got[:3], want[:3]
                msgs.append(label + " " + _compare(name, dtype, got, want, errs).split(" ", 1)[1])
                del got
            if not torch.equal(calls[0][2](), out):
                raise AssertionError(f"4L with row statistics differs at {dname} B={b} {sq}x{skv}")
            # Rate 0 is #2 / #3L, bit for bit, on both routes.
            out0, lse0 = att.fused_attention_dropout_long_cuda(q, k, v, bias, HEADS, 0.0, seed, lse=True)
            pairs = [(att.fused_attention_dropout_long_bwd_cuda(q, k, v, bias, g, HEADS, 0.0, seed, lse0, **kw),
                      att.fused_attention_long_bwd_cuda(q, k, v, bias, g, HEADS, lse2, **kw3))
                     for kw, kw3 in (({}, {}), ({"dbias": False, "out": out0}, {"dbias": False, "out": out2}))]
            if not (torch.equal(out0, out2) and torch.equal(lse0, lse2)
                    and all((x is None and y is None) or torch.equal(x, y)
                            for got, ref in pairs for x, y in zip(got, ref))):
                raise AssertionError(f"rate 0 of 4L/5L differs from #2/#3L at {dname} B={b} {sq}x{skv}")
            del out0, lse0, pairs
            msg = (f"{dname} B={b} {sq}x{skv}: max|kernel-plain| " + "; ".join(msgs)
                   + "; 4L with statistics: equal bits; rate 0 == #2/#3L bit for bit on both routes")
            if (sq, skv) == (165, 165):
                for label, _, kernel, _ in calls:
                    first, again = kernel(), kernel()
                    if isinstance(first, torch.Tensor):
                        first, again = (first,), (again,)
                    if not all((x is None and y is None) or torch.equal(x, y) for x, y in zip(first, again)):
                        raise AssertionError(f"{label} reruns differ at {dname} B={b} {sq}x{skv}")
                msg += "; 4L/5L/#3L reruns bit-identical"
            if dtype == torch.float32:
                dv = calls[2][2]()[2]
                lhs = (out.double() * g.double()).sum().item()
                rhs = (dv.double() * v.double()).sum().item()
                if not abs(lhs - rhs) <= 2e-3 * abs(lhs):
                    raise AssertionError(f"<g, out> {lhs} != <dv, v> {rhs} at {dname} B={b} {sq}x{skv}")
                msg += f"; <g,out>/<dv,v> - 1 = {lhs / rhs - 1:.1e}"
                del dv
            if dtype == torch.bfloat16 or ((sq, skv), b) in DROP_LONG_F32_TIMED:
                lib = _sdpa_calls(q, k, v, g, bias)
                drop_ms = dev_ms(lib["drop"])
                library = {"4L": drop_ms, "5L": dev_ms(lib["drop_fwd_bwd"]) - drop_ms}
                library["5L dbias"] = library["#3L"] = library["5L"]
                # The plain versions by CUDA events: hundreds of launches a
                # call, which the profiler's buffers drop.
                plain_ms = {"4L": cuda_ms(calls[0][3], iters=DROP_LONG_ITERS),
                            "5L": cuda_ms(plain_bwd.__wrapped__, iters=DROP_LONG_ITERS)}
                plain_ms["5L dbias"] = plain_ms["5L"]
                plain_ms["#3L"] = cuda_ms(plain3.__wrapped__, iters=DROP_LONG_ITERS)
                for label, name, kernel, _ in calls:
                    bound, by = _bound_ms(name, b, sq, skv, q.element_size())
                    times[(label, dname, sq, skv, b)] = (dev_ms(kernel), plain_ms[label], library[label], bound, by)
                msg += "; us kernel (device)/plain (events)/SDPA(dropout_p) (device)/bound: " + ", ".join(
                    f"{label} " + "/".join(f"{x * 1e3:.1f}" for x in times[(label, dname, sq, skv, b)][:4])
                    for label, *_ in calls)
            log("long-dropout", msg)
            del q, k, v, g, bias, out, lse, out2, lse2, calls, plain_bwd, plain3
            torch.cuda.empty_cache()
        # Each body's mask: the f32 whole-row body (76) and key-tiled one
        # (277); the bf16 wgmma body at both.
        log("long-dropout", "; ".join(_drop_long_readout(att, gen, s, dtype) for s in (UNITER_LONG[0], 277)))
    return errs, times


# The UNITER-76 step's gradients, kernels against the plain versions at
# the same seeds and masks: relative L2 error of all the gradients at
# most UNITER_LONG_GRAD_RTOL (both compute in bf16; the kernels round P
# and dS to bf16 where the plain versions keep f32, as for the losses'
# LOSS_RTOL; 3.3e-3 measured on the H100).
UNITER_LONG_GRAD_RTOL = 1e-2
ENTRY_ITERS = 20  # forwards timed, kernels and plain in turns


def _one_step_grads(model, forward, init, batch, use_fused):
    """One RP step at dropout 0.1 from ``init`` with the seeds of
    ``_run_steps`` and a zero learning rate: (loss, every gradient as the
    step clipped it, flattened f32)."""
    import torch
    from rgqa_tpu_torch.ops.dropout import DropoutRng
    from rgqa_tpu_torch.train.step import make_train_step

    model.load_state_dict(init)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    rng = DropoutRng(device=torch.Generator(device="cuda").manual_seed(1), host=torch.Generator().manual_seed(1))
    loss = make_train_step(forward, opt, sample_pair=True, rng=rng, use_fused=use_fused)(batch)["loss"]
    grads = torch.cat([p.grad.float().flatten() for p in model.parameters() if p.grad is not None])
    return float(loss), grads


def phase_uniter_long() -> dict:
    """Phase 52: UNITER with 40-token questions (a 76-token stream) at full
    width: RP training steps through the kernels and the plain versions
    (12 4L and 12 5L launches a step, no #4 / #5), one step's loss and
    gradients held to the plain path's, and an MC-dropout batch of 256
    (12 4L a pass, no 5L) held to the plain re-score.  Returns the
    launches of the two steps through the kernels."""
    import torch
    from rgqa_tpu_torch.data.batching import to_device
    from rgqa_tpu_torch.models.zoo import build_model, default_config, example_batch
    from rgqa_tpu_torch.scorers.core import make_dropout_scorer

    phase, per = "uniter76", UNITER_PER_FORWARD
    steps = phase_train_steps("uniter", dropouts=(RATE,), n=2, timed=4, phase=phase, text=UNITER_LONG_TEXT)
    counts = steps[RATE][0]

    cfg, model, forward = _train_model(RATE, "uniter", text=UNITER_LONG_TEXT)
    batch = _train_batches(cfg, 1)[0]
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    reset_counts()
    k_loss, k_grads = _one_step_grads(model, forward, init, batch, None)
    launched = read_counts()
    p_loss, p_grads = _one_step_grads(model, forward, init, batch, False)
    if read_counts() != launched:
        raise AssertionError("the plain step launched a kernel")
    rel = ((k_grads - p_grads).norm() / p_grads.norm()).item()
    want = _step_launches("uniter", RATE, long=True)
    log(phase, f"one RP step at dropout 0.1, batch 32 + RP, 76 tokens: loss kernels {k_loss:.6f}, plain "
        f"{p_loss:.6f} (relative gap {abs(k_loss - p_loss) / abs(p_loss):.3e}, bound {LOSS_RTOL:.0e}); gradients' "
        f"relative L2 gap {rel:.3e} over {p_grads.numel()} values (bound {UNITER_LONG_GRAD_RTOL:.0e}); "
        f"launches {({k: v for k, v in launched.items() if v})}")
    if launched != want:
        raise AssertionError(f"launches {launched}, want {want}")
    if not abs(k_loss - p_loss) <= LOSS_RTOL * abs(p_loss) or not rel <= UNITER_LONG_GRAD_RTOL:
        raise AssertionError("the UNITER-76 step's loss or gradients left their bounds")
    del model, forward, init, batch, k_grads, p_grads
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(default_config("uniter"), max_text_len=UNITER_LONG_TEXT)
    model, forward = build_model(cfg, use_bf16=True, device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(0))
    batch = to_device(_padded_text(example_batch(cfg, 256, seed=7), seed=8), "cuda")
    plain = functools.partial(forward, use_fused=False)
    score_k, score_p = make_dropout_scorer(forward, SEED_LIST), make_dropout_scorer(plain, SEED_LIST)
    score_k(batch)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    got = score_k(batch)
    torch.cuda.synchronize()
    mc = read_counts()
    ref = score_p(batch)
    if read_counts() != mc:
        raise AssertionError("the plain MC-dropout passes launched a kernel")
    diff = (got["score"].float() - ref["score"].float()).abs().max().item()
    agree = (got["label"] == ref["label"]).float().mean().item()
    plain_ms, kernel_ms = in_turns(lambda: score_p(batch), lambda: score_k(batch), iters=3, warmup=1)
    want = {**{k: 0 for k in KERNELS}, "fused_attention_dropout_long": per * len(SEED_LIST)}
    log(phase, f"MC-dropout batch of 256 at 76 tokens ({len(SEED_LIST)} passes): launches "
        f"{({k: v for k, v in mc.items() if v})}; max|score kernels - plain| {diff:.3e} (bound {CONF_TOL}); "
        f"labels agree on {agree:.4f}; ms a batch kernels {kernel_ms:.3f}, plain {plain_ms:.3f}")
    if mc != want:
        raise AssertionError(f"MC-dropout launches {mc}, want {want}")
    if not diff <= CONF_TOL or agree < MIN_LABEL_AGREEMENT:
        raise AssertionError("the MC-dropout scores left their bound")
    del model, forward, batch
    torch.cuda.empty_cache()
    return counts


def phase_entry(dryruns) -> None:
    """Phase 53: ``rgqa_tpu_torch.entry.entry()`` at full width (LXMERT,
    batch 8, bf16) through the kernels and through the plain versions
    (34 #1 a forward; MSP within CONF_TOL; the answers equal on the rows
    whose plain top-2 margin exceeds twice the largest gap between the
    two paths' probabilities), then the dry runs that ``dryruns``
    (a future) ran on two gloo ranks on cuda:0 beside it, each held to
    the JAX dry run's assertions, the tiny one's loss to one process's."""
    import torch
    from rgqa_tpu_torch import entry

    phase = "entry"
    fwd, (model, batch) = entry.entry()
    fwd(model, batch)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    label, score = fwd(model, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    plain_label, plain_score = fwd(model, batch, use_fused=False)
    if read_counts() != counts:
        raise AssertionError("entry()'s plain forward launched a kernel")
    with torch.inference_mode():
        args = [batch[k] for k in ("input_ids", "input_mask", "segment_ids", "feats", "boxes")]
        probs, plain_probs = (torch.sigmoid(model(*args, use_fused=fused)["logits"].float()) for fused in (None, False))
    eps = (probs - plain_probs).abs().max().item()
    top2 = plain_probs.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * eps
    diff = (score - plain_score).abs().max().item()
    plain_ms, kernel_ms = in_turns(lambda: fwd(model, batch, use_fused=False), lambda: fwd(model, batch),
                                   iters=ENTRY_ITERS)
    log(phase, f"entry(): LXMERT 9/5/5 x 768, batch 8, bf16: label {tuple(label.shape)}, launches "
        f"{({k: v for k, v in counts.items() if v})}; max|MSP kernels - plain| {diff:.3e} (bound {CONF_TOL}); "
        f"largest probability gap {eps:.3e}; answers equal on the {int(decided.sum())} of 8 rows with a top-2 "
        f"margin over twice it: "
        f"{bool((label == plain_label)[decided].all())}; ms a forward kernels {kernel_ms:.3f}, plain {plain_ms:.3f}")
    if counts != {**{k: 0 for k in KERNELS}, "fused_attention": 34} or not diff <= CONF_TOL \
            or not bool((label == plain_label)[decided].all()):
        raise AssertionError("entry() through the kernels differs from its plain run")
    del model, batch
    torch.cuda.empty_cache()
    one = entry.dryrun_step(entry.tiny_config(), 4, device=torch.device("cuda"))
    for name, record, seconds in dryruns.result():
        log(phase, f"{name}(2) on {record['backend']} ranks (rank 0 on {record['device']}) in {seconds:.1f} s: loss "
            f"{record['loss']:.6f}, step {record['step']}, labels {len(record['label'])}, scores "
            f"[{min(record['score']):.4f}, {max(record['score']):.4f}]")
        if not math.isfinite(record["loss"]) or record["world"] != 2 or record["step"] != 1:
            raise AssertionError(f"{name}: {record}")
    tiny = dryruns.result()[0][1]
    gap = abs(tiny["loss"] - one["loss"]) / abs(one["loss"])
    log(phase, f"dryrun_multichip(2) against one process at the global batch of 4: loss {tiny['loss']:.6f} vs "
        f"{one['loss']:.6f} (relative gap {gap:.3e}, bound {DP_RTOL:.0e}); labels equal: "
        f"{tiny['label'] == one['label']}")
    if not gap <= DP_RTOL or tiny["label"] != one["label"]:
        raise AssertionError("dryrun_multichip(2) differs from one process")


def _dryruns() -> list:
    """dryrun_multichip(2) and dryrun_multichip_fullshape(2) on two gloo
    ranks on the one card: [(name, record, seconds)]."""
    from rgqa_tpu_torch import entry

    out = []
    for fn in (entry.dryrun_multichip, entry.dryrun_multichip_fullshape):
        t0 = time.perf_counter()
        out.append((fn.__name__, fn(2), time.perf_counter() - t0))
    return out


def phase_slice24() -> dict:
    """Phases 52-53: the dry runs' ranks start first, beside UNITER-76 and
    entry(); returns the UNITER-76 steps' launches."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        dryruns = pool.submit(_dryruns)
        launches = timed("52 UNITER at 76 tokens", phase_uniter_long)
        timed("53 entry and the dry runs", phase_entry, dryruns)
    return launches


# ---------------------------------------------------------------------------
# Phase 54 (slice 26): the f32 model paths through the long f32 bodies.
# ---------------------------------------------------------------------------

# The kernels against the plain versions in f32, on the same weights and
# seeds: the f32 bodies sum their products in another order than the
# plain einsums (a few 1e-6 apart at an attention output, phase 3), which
# 12 layers carry into the loss at round-off's size: 1e-5 relative holds
# it with room.  Every gradient, and a forward's logits, within the f32
# bar 1e-4 + 1e-4 |plain| (TOL's f32 1e-4, plus a relative term for the
# large ones).
F32_LOSS_RTOL = 1e-5
F32_BAR = (1e-4, 1e-4)
VILT_F32_TEXT = 40  # ViLT-B/32 at 40-token text: the 185-token stream


def _within_bar(got, want) -> tuple[float, bool]:
    """max |got - want| and whether every element is within F32_BAR."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), bool((diff <= F32_BAR[0] + F32_BAR[1] * want.float().abs()).all())


def _f32_step(phase: str, backbone: str, dropout: float, text: int) -> dict:
    """One RP step under ``--fp32`` (f32 weights and products) at batch 32
    + RP, through the kernels and the plain versions from one init and the
    same seeds: the loss within F32_LOSS_RTOL, every gradient within
    F32_BAR, the launches a step; ms a step of each, in turns.  Returns the
    launches."""
    import torch

    cfg, model, forward = _train_model(dropout, backbone, text=text, fp32=True)
    batch = _train_batches(cfg, 1)[0]
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    reset_counts()
    k_loss, k_grads = _one_step_grads(model, forward, init, batch, None)
    launched = read_counts()
    p_loss, p_grads = _one_step_grads(model, forward, init, batch, False)
    if read_counts() != launched:
        raise AssertionError(f"{phase}: the plain step launched a kernel")
    want = _step_launches(backbone, dropout, long=backbone != "vilt")
    gap = abs(k_loss - p_loss) / abs(p_loss)
    err, ok = _within_bar(k_grads, p_grads)
    t = [_run_steps(model, forward, init, [batch], fused, 4)[1] for fused in (False, None, None, False)]
    plain_ms, kernel_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    stream = cfg.max_text_len + (36 if backbone != "vilt" else (cfg.vilt_image_size // cfg.vilt_patch_size) ** 2 + 1)
    log(phase, f"{backbone} --fp32, {stream} tokens, dropout {dropout}, one RP step at batch 32 + RP: loss kernels "
        f"{k_loss:.6f}, plain {p_loss:.6f} (relative gap {gap:.3e}, bound {F32_LOSS_RTOL:.0e}); gradients "
        f"max|kernels - plain| {err:.3e} over {p_grads.numel()} values (bound {F32_BAR[0]:.0e} + "
        f"{F32_BAR[1]:.0e} |plain|: {'held' if ok else 'LEFT'}); launches {({k: v for k, v in launched.items() if v})}; "
        f"ms a step (3 after 1, in turns) kernels {kernel_ms:.3f}, plain {plain_ms:.3f}")
    if launched != want:
        raise AssertionError(f"{phase}: launches {launched}, want {want}")
    if not gap <= F32_LOSS_RTOL or not ok:
        raise AssertionError(f"{phase}: the {backbone} --fp32 step's loss or gradients left their bounds")
    del model, forward, init, batch, k_grads, p_grads
    torch.cuda.empty_cache()
    return launched


def phase_f32_long_paths() -> None:
    """Phase 54: ViLT-B/32 and UNITER-76 under ``--fp32`` through the long
    f32 bodies: ViLT RP steps at 185 tokens at dropout 0.1 and 0 (12 #2
    and 12 #3L a step: ViLT has no attention dropout), a ViLT evaluation
    forward at batch 256 (12 #2, logits within F32_BAR of the plain
    forward's), UNITER-76 RP steps at dropout 0.1 (12 4L and 12 5L)."""
    import torch
    from rgqa_tpu_torch.data.batching import to_device
    from rgqa_tpu_torch.models.zoo import build_model, default_config, example_batch

    phase = "f32-long"
    for dropout in (RATE, 0.0):
        _f32_step(phase, "vilt", dropout, VILT_F32_TEXT)
    _f32_step(phase, "uniter", RATE, UNITER_LONG_TEXT)

    cfg = dataclasses.replace(default_config("vilt"), max_text_len=VILT_F32_TEXT)
    _, forward = build_model(cfg, use_bf16=False, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(0))
    batch = to_device(_padded_text(example_batch(cfg, 256, seed=0, pixel_wire="u8")), "cuda")
    with torch.inference_mode():
        forward(batch)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        logits = forward(batch)["logits"]
        torch.cuda.synchronize()
        launched = read_counts()
        plain = forward(batch, use_fused=False)["logits"]
        if read_counts() != launched:
            raise AssertionError(f"{phase}: the plain forward launched a kernel")
        err, ok = _within_bar(logits, plain)
        plain_ms, kernel_ms = in_turns(lambda: forward(batch, use_fused=False), lambda: forward(batch), iters=5,
                                       warmup=1)
    want = {**{k: 0 for k in KERNELS}, "fused_attention_long": cfg.encoder.num_layers}
    log(phase, f"vilt --fp32 evaluation forward at batch 256, 185 tokens: launches "
        f"{({k: v for k, v in launched.items() if v})}; max|logits kernels - plain| {err:.3e} (bound "
        f"{F32_BAR[0]:.0e} + {F32_BAR[1]:.0e} |plain|, max|logit| {plain.abs().max().item():.3f}); finite "
        f"{bool(torch.isfinite(logits).all())}; ms a forward kernels {kernel_ms:.3f}, plain {plain_ms:.3f}")
    if launched != want or not ok or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{phase}: the ViLT --fp32 forward: launches {launched} (want {want}), logits "
                             f"within the bar: {ok}")
    del forward, batch, logits, plain
    torch.cuda.empty_cache()


def timed(name: str, fn, *args):
    """``fn(*args)``, its run time logged under ``name`` with the most card
    memory this process reserved since the last such line; the cache is
    then emptied, so that the lanes beside share the card."""
    t0 = time.perf_counter()
    out = fn(*args)
    seconds, peak = time.perf_counter() - t0, ""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        peak = f" (at most {torch.cuda.max_memory_reserved() / 2**30:.1f} GiB reserved)"
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.empty_cache()
    log("time", f"{name}: {seconds:.1f} s{peak}")
    return out


def phase_prepare_serve():
    """Phases 16-17 in one temporary directory."""
    with tempfile.TemporaryDirectory(prefix="rgqa_smoke_serve_") as tmp:
        phase_serve(tmp, *phase_prepare(tmp))


# ---------------------------------------------------------------------------
# The lanes: after the timed phases, three runs of phases side by side,
# lane a in this process, b and c each in a child process.
# ---------------------------------------------------------------------------

LANE_SECONDS = 900  # the most a child lane may take once started


def lane_b() -> dict:
    timed("14 scorers", phase_scorers)
    timed("15 scorer CLI", phase_scorer_cli)
    timed("16-17 prepare and serve", phase_prepare_serve)
    timed("18-22 UNITER", phase_uniter)
    timed("23-27 BUTD and caps", phase_butd_caps)
    timed("35-36 new strategies", phase_new_strategies)
    return {}


def lane_c() -> dict:
    launches = timed("13 the experiment entry points", _run_experiments)
    timed("37-41 weight model, distill, verifier, compute_param", phase_slice19)
    timed("42-45 pretraining, VQA and NLVR2", phase_slice21)
    timed("46-49 data parallel", phase_slice22)
    timed("50 recipes", phase_recipes)
    return {"experiments": launches}


LANES = {"b": lane_b, "c": lane_c}


def _lane_child(name: str, result: str) -> None:
    """Child mode (``chip_smoke.py --lane NAME RESULT``): lane ``name``'s
    phases under phase 1's settings, their results written to ``RESULT``
    as JSON.  Should this script's main process end first (killed), the
    lane ends itself and what it started."""
    import threading

    import torch

    parent = os.getppid()

    def orphaned():
        while os.getppid() == parent:
            time.sleep(1)
        os.killpg(0, signal.SIGKILL)

    threading.Thread(target=orphaned, daemon=True).start()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = LANES[name]()
    log("time", f"lane {name}: {time.perf_counter() - t0:.1f} s")
    with open(result, "w") as f:
        json.dump(out, f)


class Lane:
    """A child lane: ``chip_smoke.py --lane NAME`` in a session of its own
    (so that :meth:`stop` ends the processes it starts too), its output to
    a file that :meth:`join` prints."""

    def __init__(self, name: str, tmp: str):
        self.name = name
        self.result = os.path.join(tmp, f"lane_{name}.json")
        self.out = open(os.path.join(tmp, f"lane_{name}.log"), "w+")
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--lane", name, self.result],
                                     stdout=self.out, stderr=subprocess.STDOUT, text=True, start_new_session=True,
                                     env=dict(os.environ, PYTHONUNBUFFERED="1"))  # its lines in order

    def join(self) -> dict:
        try:
            rc = self.proc.wait(timeout=LANE_SECONDS)
        except subprocess.TimeoutExpired:
            rc = None
        self.out.seek(0)
        text = self.out.read()
        print(f"[lane] lane {self.name}'s output, printed as it ends:", flush=True)
        sys.stdout.write(text)
        sys.stdout.flush()
        if rc != 0:
            raise AssertionError(f"lane {self.name} " + ("ran past its time limit" if rc is None else
                                                         f"exited {rc}") + f":\n{text[-3000:]}")
        with open(self.result) as f:
            return json.load(f)

    def stop(self) -> None:
        """End the lane's process and whatever it started."""
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()
        self.out.close()


def main() -> None:
    t0 = time.perf_counter()
    if sys.argv[1:2] == ["--train-cli-rank"]:  # a child of phase 46, under torchrun
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _train_cli_rank(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--lane"]:  # lane b or c, a child of this script
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _lane_child(*sys.argv[2:4])
        return
    kind, smi = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))  # so that the lanes are stopped
    # The timed phases first, alone on the card: their times go into the
    # kernels' line.
    timed("2 build", phase_build)
    errs, times = timed("3 kernels", phase_kernels)
    drop_errs, drop_times = timed("51 long-stream dropout kernels", phase_long_dropout_kernels)
    errs.update(drop_errs)
    exp_times = {}
    timed("13 experiments", phase_experiments, errs, exp_times)
    keep = tempfile.mkdtemp(prefix="rgqa_smoke_keep_")  # the train CLI's root and BEST.pth
    lanes_dir = tempfile.mkdtemp(prefix="rgqa_smoke_lanes_")
    lanes = []
    try:
        lanes = [Lane(name, lanes_dir) for name in LANES]
        log("lane", f"lanes {', '.join(LANES)} started beside lane a (this process)")
        t1 = time.perf_counter()
        timed("4 model", phase_model)
        eval_launches = timed("5 evaluate", phase_main_path)
        timed("6 vilt model", phase_vilt_model)
        vilt_launches = timed("7 vilt evaluate", phase_main_path, "vilt", ("--backbone", "vilt"),
                              "fused_attention_long", 12)
        steps = timed("8 train steps", phase_train_steps)
        train_launches = timed("9 train", phase_train_path, keep)
        timed("10 vilt train steps", phase_train_steps, "vilt")
        vilt_train_launches = timed("11 vilt train", phase_vilt_train_path)
        timed("12 vilt long", phase_vilt_long)
        timed("28-31 CLIP and match", phase_clip_match, keep)
        timed("32-34 strategies and frcnn", phase_strategies, keep)
        uniter_long_launches = phase_slice24()
        timed("54 f32 model paths", phase_f32_long_paths)
        log("time", f"lane a: {time.perf_counter() - t1:.1f} s")
        results = {lane.name: lane.join() for lane in lanes}
    finally:
        for lane in lanes:
            lane.stop()
        shutil.rmtree(keep, ignore_errors=True)
        shutil.rmtree(lanes_dir, ignore_errors=True)
    exp_launches = results["c"]["experiments"]
    log("time", f"all phases: {time.perf_counter() - t0:.1f} s")

    launches = {
        "fused_attention": eval_launches,  # the evaluate path
        "fused_attention_bwd": steps[0.0][0]["fused_attention_bwd"],  # dropout-off steps
        "fused_attention_dropout": train_launches["fused_attention_dropout"],  # the train CLI
        "fused_attention_dropout_bwd": train_launches["fused_attention_dropout_bwd"],
        "fused_attention_long": vilt_launches,  # the ViLT evaluate path
        "fused_attention_long_bwd": vilt_train_launches["fused_attention_long_bwd"],  # the ViLT train CLI
        # UNITER's RP steps at 40-token questions (phase 52)
        "fused_attention_dropout_long": uniter_long_launches["fused_attention_dropout_long"],
        "fused_attention_dropout_long_bwd": uniter_long_launches["fused_attention_dropout_long_bwd"],
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
        if name in ("fused_attention_dropout_long", "fused_attention_dropout_long_bwd"):
            # One bf16 call at the UNITER-76 step's shape, batch 32, on the
            # step's route (device time: at this batch events time the host).
            label = "4L" if name == "fused_attention_dropout_long" else "5L"
            kernel_ms, plain_ms, library_ms, bound, by = drop_times[(label, "bfloat16", *DROP_LONG_MAIN[0],
                                                                     DROP_LONG_MAIN[1])]
            rows.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": errs[(name, "bfloat16")],
                "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": library_ms,
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
