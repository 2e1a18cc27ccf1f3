"""Typed configuration for RGQA-TPU (a copy of ``rgqa_tpu/config.py``).

Replaces the reference's import-time global argparse singleton
(``src/param.py:33-150``) with frozen dataclasses, while keeping a CLI
adapter that accepts the reference's flag names (``--llayers``, ``--tau``,
``--loadLXMERTQA``, ...) so existing experiment recipes port over
mechanically.

The port keeps this copy so that it imports nothing of the JAX package;
``tests/test_torch_port_rules.py`` holds it to the original.  The one
addition is ``--device {cuda,cpu}`` (default ``cuda``), which lives on
the namespace ``parse_cli`` returns, not on ``RunConfig``: the port's
CLIs run on the card unless asked for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass(frozen=True)
class EncoderConfig:
    """Shared transformer encoder shape (BERT-base defaults, eps 1e-12).

    Covers LXMERT (reference ``src/lxrt/modeling.py:141-169``), UNITER
    (``src/uniter/entry.py:58-60``) and the caption matcher with one type.
    """

    hidden_size: int = 768
    num_heads: int = 12
    intermediate_size: int = 3072
    vocab_size: int = 30522
    type_vocab_size: int = 2
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    # LXMERT stack depths (language / cross-modality / object-relationship).
    l_layers: int = 9
    x_layers: int = 5
    r_layers: int = 5
    # Single-stream depth (UNITER / caption BERT).
    num_layers: int = 12
    # Visual inputs: Faster-RCNN RoI features + box geometry.
    visual_feat_dim: int = 2048
    visual_pos_dim: int = 4  # 7 for UNITER's box transform
    num_objects: int = 36
    # Pretraining label spaces (Visual Genome detections).
    obj_vocab_size: int = 1600
    attr_vocab_size: int = 400

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class ModelConfig:
    """A backbone + answer-head configuration."""

    backbone: str = "lxmert"  # lxmert | uniter | butd | vilt | caps
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    num_answers: int = 1842
    max_text_len: int = 20  # LXMERT/UNITER question length; BUTD uses 40
    # BUTD-specific shape (reference src/butd/butd.py:113-131).
    butd_embed_dim: int = 300
    butd_hidden_dim: int = 1024
    butd_vocab_size: int = 2941  # GQA question vocab (preprocess.py builds it)
    # ViLT-specific shape (ViT-B/32).
    vilt_patch_size: int = 32
    vilt_image_size: int = 384
    # Train 'UQ' as a real answer class (reference gqa.py get_tuple_uq,
    # :37-52): the model outputs num_answers *including* UQ instead of the
    # conf-style K-1 + indicator convention.
    uq_as_class: bool = False
    # Branched-confidence head (reference gqa_model_branched.py:28-51).
    branched: bool = False
    # Layer-tapped confidence branch (reference gqa_branched_layer.py).
    branched_layers: bool = False
    project_size: int = 128


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer recipe (reference BertAdam, ``src/lxrt/optimization.py``)."""

    name: str = "bert"  # bert | adam | adamw | sgd
    lr: float = 1e-5
    warmup: float = 0.1
    weight_decay: float = 0.01
    grad_clip: float = 5.0
    schedule: str = "warmup_linear"
    # BertAdam semantics: no bias correction (optimization.py:52+).
    bias_correction: bool = False
    # Store Adam mu/nu in bf16 (halves optimizer-state HBM traffic; f32
    # math).  Off by default: f32 moments are the reference trajectory.
    bf16_moments: bool = False


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    epochs: int = 4
    seed: int = 9595
    # Training strategy: conf (vanilla/RP/mixup via flags below), separate
    # (binary UQ detector), adv (VILLA), resampling | poem | woods
    # (dual pos/neg loaders), caption (Q-C matcher).
    strategy: str = "conf"
    lr_w: float = 0.1  # negative-weight SGD lr (gqa_resampling.py:140)
    # Adversarial CLIP update for --strategy weight: the weight model is
    # trained to MAXIMIZE the weighted negative loss (gqa_weight.py:228-238,
    # optim_w = Adam(1e-5) on loss_w = -loss_neg).  Requires --clip_path
    # and raw images under <data_root>/images.
    update_weight_model: bool = False
    adv_steps: int = 3
    adv_lr_txt: float = 1e-3
    adv_lr_img: float = 1e-3
    adv_max_norm: float = 0.0
    adv_kl_weight: float = 1.5
    adv_norm_type: str = "l2"
    optim: OptimConfig = field(default_factory=OptimConfig)
    dropout: float = 0.1
    # Loss: 'bce' = per-answer binary CE x num_answers (reference
    # gqa_conf.py:197); 'mce' = softmax CE (--mceLoss).
    loss: str = "bce"
    # RP pseudo-UQ in-batch negative pairing (gqa_conf.py:155-170).
    sample_pair: bool = False
    # Mixup-RoI (gqa_mixup_vis.py): mode + beta params.
    mixup_mode: Optional[str] = None
    mixup_alpha: float = 1.0
    mixup_beta: float = 1.0
    lam: float = 0.5
    lam1: float = 0.5
    lam2: float = 0.05
    # Energy regularization margins (gqa_energy.py:122-138).
    m_in: float = 25.0
    m_out: float = 0.0
    # Cartography chart dumps (gqa.py:141-150).
    chart: bool = False
    save_all: bool = False
    # Mixed precision: bf16 compute with f32 params/optimizer state.
    use_bf16: bool = True
    # Eval batches per device dispatch (data/batching.py::chunked_map).
    # >1 runs one jitted lax.scan over each group of K batches — K-fold
    # fewer dispatches where each dispatch pays a synchronous round trip
    # (remote/tunneled chips; measured 3.4x on the scoring loop,
    # docs/kernels.md).  1 = per-batch dispatch (host-attached default).
    eval_chunk: int = 1
    # Optimizer steps per device dispatch (train/step.py::
    # make_chunked_train_step) — the training analogue of eval_chunk.
    # Trajectory-identical to the per-step loop (same key sequence).
    train_chunk: int = 1


@dataclass(frozen=True)
class OODConfig:
    """Rejection-scoring configuration (reference flags param.py:41-54)."""

    scorer: str = "msp"
    tau: float = 0.5
    temperature: float = 1.0
    noise: float = 0.0
    target_acc: Optional[float] = None
    seed_list: tuple[int, ...] = ()
    ensemble_method: str = "mean"
    topk: int = 5
    mix_branched_score: bool = False
    # Local HF CLIP checkpoint dir for the clip scorer and the weight
    # strategy (reference hardcodes openai/clip-vit-base-patch32 hub
    # downloads, gqa_clip.py:76 / gqa_weight.py:80; zero-egress here).
    clip_path: Optional[str] = None


@dataclass(frozen=True)
class DataConfig:
    data_root: str = "data"
    train_splits: str = "train"
    valid_splits: str = "valid"
    test_splits: Optional[str] = None
    train_pos: str = "train"
    train_neg: str = "train"
    tiny: bool = False  # 512 images (gqa_data.py:21)
    fast: bool = False  # 5000 images (gqa_data.py:22)
    num_workers: int = 0
    # Pretraining answer-vocab filter (reference --qaSets,
    # lxmert_pretrain.py:27-32): comma list of QA dataset names; with an
    # all_ans.json present, only answers used in these dsets survive.
    qa_sets: Optional[str] = None
    # ViLT static-shape image policy: "pad" (longer side -> size,
    # masked center pad) or "crop" (shorter side -> size, center crop —
    # the reference MinMaxResize patch scale).  docs/vilt_images.md.
    vilt_resize: str = "pad"
    # GloVe-300 text file for BUTD word-embedding init (reference
    # ``butd/preprocess.py:54-123`` hardcodes data/butd/glove.6B.300d.txt;
    # None = auto-detect <data_root>/butd/glove.6B.300d.txt, skip if absent).
    glove_path: Optional[str] = None
    synthetic: bool = False  # generate synthetic data (this environment
    # has no GQA download; see data/synthetic.py)
    # Eval-only int8 feature transport (per-RoI scales, in-jit dequant):
    # quarters the dominant host->device bytes on wire-bound links at a
    # ~0.4%-per-element quantization cost (docs/kernels.md "Feats-wire
    # int8": shipped path 598.0 vs 241.4 q/s = 2.48x production
    # throughput).  Grad-at-eval scorers and the Mahalanobis estimator
    # fit exempt themselves; training (incl. its per-epoch validation
    # and BEST selection) always feeds exact.
    feed_int8: bool = False
    # Pixel transport for image backbones (ViLT): "u8" ships uint8 +
    # real-pixel rect and normalizes in-jit — zero quantization error
    # (the uint8 wire IS the source lattice; pad zeroing and the
    # pad-patch mask travel as rect geometry; <= 1-ulp jit
    # reassociation, ops/pixels.py) at 1/4 the f32 wire bytes and no
    # host normalize.  "f32" keeps the legacy host-normalized feed.
    pixel_wire: str = "u8"
    # ViLT train-time photometric randaug (the reference ViLT dataset's
    # pixelbert_randaug transform, gqa_data.py:341).  Train split only —
    # eval pixels stay deterministic; a PixelPack cannot serve the
    # augmented train split (rows are pre-resized), so the train split
    # decodes raw JPEGs while eval may still ride the pack.
    vilt_randaug: bool = True


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout for SPMD execution.

    ``data`` shards the batch over ICI; ``model`` optionally shards
    attention heads / FFN / answer vocab (tensor parallelism). At RGQA model
    sizes DP alone is the right default (SURVEY.md §2.3).
    """

    data_axis: int = -1  # -1 = all devices
    model_axis: int = 1


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    ood: OODConfig = field(default_factory=OODConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    output: str = "snap/test"
    load: Optional[str] = None
    load_lxmert: Optional[str] = None
    load_lxmert_qa: Optional[str] = None
    load_gqa: Optional[str] = None
    # Local HF bert-base-uncased ckpt for the caption matcher's init
    # (reference BertModel.from_pretrained, caps.py:17).
    load_bert: Optional[str] = None
    teacher_path: Optional[str] = None
    from_scratch: bool = False

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def dump_run_config(cfg: RunConfig, output: str) -> str:
    """Write the resolved RunConfig (+ git sha) into ``<output>/``.

    The reference snapshots all of ``src/`` into each run directory for
    reproducibility (``run/gqa_conf_finetune.bash:6-8``); the typed-config
    equivalent is the full resolved configuration plus the code revision.
    """
    import json
    import os
    import subprocess

    os.makedirs(output, exist_ok=True)
    payload = dataclasses.asdict(cfg)
    try:
        payload["git_sha"] = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or None
    except Exception:
        payload["git_sha"] = None
    path = os.path.join(output, "run_config.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    return path


def _build_parser() -> argparse.ArgumentParser:
    """CLI accepting the reference's flag names (``src/param.py:33-150``)."""
    p = argparse.ArgumentParser(description="RGQA-TPU")
    # Splits / data
    p.add_argument("--train", default="train")
    p.add_argument("--valid", default="valid")
    p.add_argument("--test", default=None)
    p.add_argument("--train_pos", default="train")
    p.add_argument("--train_neg", default="train")
    p.add_argument("--data_root", default="data")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--fast", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--numWorkers", dest="num_workers", type=int, default=0)
    # Training
    p.add_argument("--batchSize", dest="batch_size", type=int, default=32)
    p.add_argument(
        "--feed_int8", action="store_true",
        help="eval-only int8 RoI-feature transport with in-jit dequant "
        "(quarters the host->device bytes on wire-bound links; "
        "grad-at-eval scorers stay exact)",
    )
    p.add_argument(
        "--no_randaug", action="store_true",
        help="disable ViLT train-time photometric randaug (the reference "
        "pixelbert_randaug transform; eval is always un-augmented)",
    )
    p.add_argument(
        "--pixel_wire", choices=("u8", "f32"), default="u8",
        help="image-backbone pixel transport: u8 = uint8 + rect with "
        "in-jit normalize (exact, 4x fewer bytes than f32); f32 = "
        "legacy host-normalized feed",
    )
    # Serving (cli/serve.py) knobs — surfaced on the shared parser so the
    # service shares every model/scorer/feed flag with the eval CLIs.
    p.add_argument(
        "--serve_stats", action="store_true",
        help="serve: report per-record latency p50/p95/p99 (JSON on "
        "stderr at shutdown)",
    )
    p.add_argument(
        "--wave_timeout", type=float, default=0.05,
        help="serve: max seconds a pending record waits for its wave to "
        "fill before a partial wave is dispatched (shallow-queue "
        "policy; 0 = always wait for a full wave)",
    )
    p.add_argument(
        "--eval_chunk", type=int, default=1,
        help="eval batches per device dispatch (chunked_map); >1 for "
        "remote/tunneled chips where each dispatch is a round trip",
    )
    p.add_argument(
        "--train_chunk", type=int, default=1,
        help="optimizer steps per device dispatch (trajectory-identical "
        "to the per-step loop); >1 for remote/tunneled chips",
    )
    p.add_argument("--optim", default="bert")
    p.add_argument(
        "--bf16_moments", action="store_true",
        help="bf16 Adam moment buffers (halves optimizer-state HBM "
        "traffic; f32 math; off = reference-parity f32 trajectory)",
    )
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=9595)
    p.add_argument("--mceLoss", dest="mce_loss", action="store_true")
    p.add_argument("--sample_pair", action="store_true")
    p.add_argument("--mixup_mode", default=None)
    p.add_argument("--mixup_alpha", type=float, default=1.0)
    p.add_argument("--mixup_beta", type=float, default=1.0)
    p.add_argument("--lam", type=float, default=0.5)
    p.add_argument("--lam1", type=float, default=0.5)
    p.add_argument("--lam2", type=float, default=0.05)
    p.add_argument("--m_in", type=float, default=25.0)
    p.add_argument("--m_out", type=float, default=0.0)
    p.add_argument("--chart", action="store_true")
    p.add_argument("--save_all", action="store_true")
    p.add_argument("--fp32", action="store_true", help="disable bf16 compute")
    p.add_argument("--strategy", default="conf")
    p.add_argument("--lr_w", type=float, default=0.1)
    p.add_argument(
        "--update_weight_model", action="store_true",
        help="adversarially train the CLIP weight model during "
        "--strategy weight (gqa_weight.py --update_weight_model)",
    )
    p.add_argument("--adv_steps", type=int, default=3)
    p.add_argument("--adv_lr_txt", type=float, default=1e-3)
    p.add_argument("--adv_lr_img", type=float, default=1e-3)
    p.add_argument("--adv_max_norm", type=float, default=0.0)
    p.add_argument("--adv_kl_weight", type=float, default=1.5)
    p.add_argument("--norm_type", dest="adv_norm_type", default="l2")
    # Model shape
    p.add_argument("--backbone", default="lxmert")
    p.add_argument("--llayers", type=int, default=9)
    p.add_argument("--xlayers", type=int, default=5)
    p.add_argument("--rlayers", type=int, default=5)
    p.add_argument("--project_size", type=int, default=128)
    # Extensions beyond the reference CLI: shrink the encoder for smoke
    # runs (the reference hard-codes bert-base).
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=None)
    p.add_argument("--num_layers", type=int, default=12,
                   help="single-stream depth (uniter / vilt / caps)")
    p.add_argument("--vilt_patch_size", type=int, default=32)
    p.add_argument("--vilt_image_size", type=int, default=384)
    p.add_argument("--branched", action="store_true")
    p.add_argument("--branched_layer", dest="branched_layers", action="store_true")
    p.add_argument("--uq_as_class", action="store_true")
    # OOD / rejection
    p.add_argument("--scorer", default="msp")
    p.add_argument("--tau", type=float, default=0.5)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--target_acc", type=float, default=None)
    p.add_argument("--seed_list", type=str, default=None)
    p.add_argument("--ensemble_method", default="mean")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--mix_branched_score", action="store_true")
    # Loading / output
    p.add_argument("--output", default="snap/test")
    p.add_argument("--load", default=None)
    p.add_argument("--loadLXMERT", dest="load_lxmert", default=None)
    p.add_argument("--loadLXMERTQA", dest="load_lxmert_qa", default=None)
    p.add_argument("--load_gqa", default=None)
    p.add_argument("--load_bert", default=None, help="local HF BERT ckpt (dir or .bin) to init the caption matcher (caps.py:17)")
    p.add_argument("--ans_backbone", default=None, help="answer-model backbone for gated (separate/caption) eval")
    p.add_argument("--clip_path", default=None, help="local CLIP checkpoint dir for --scorer clip / --strategy weight")
    p.add_argument("--teacher_path", default=None)
    p.add_argument("--fromScratch", dest="from_scratch", action="store_true")
    # Pretraining tasks
    p.add_argument("--taskMatched", dest="task_matched", action="store_true")
    p.add_argument("--taskMaskLM", dest="task_mask_lm", action="store_true")
    p.add_argument("--taskObjPredict", dest="task_obj_predict", action="store_true")
    p.add_argument("--taskQA", dest="task_qa", action="store_true")
    p.add_argument("--visualLosses", dest="visual_losses", default="obj,attr,feat")
    p.add_argument("--qaSets", dest="qa_sets", default=None)
    p.add_argument("--vilt_resize", choices=("pad", "crop"), default="pad")
    p.add_argument(
        "--glove", dest="glove_path", default=None,
        help="GloVe-300 txt for BUTD embedding init (butd/preprocess.py)",
    )
    p.add_argument("--wordMaskRate", dest="word_mask_rate", type=float, default=0.15)
    p.add_argument("--objMaskRate", dest="obj_mask_rate", type=float, default=0.15)
    # Accepted for script compatibility; multi-device use is controlled by
    # the mesh, not this flag.
    p.add_argument("--multiGPU", action="store_true")
    p.add_argument("--model_axis", type=int, default=1,
                   help="tensor-parallel mesh axis size (devices per model shard)")
    p.add_argument("--tqdm", action="store_true")
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the port runs: the card (default; raises without one) "
        "or, when asked, the CPU",
    )
    return p


def parse_cli(argv: Optional[Sequence[str]] = None) -> tuple[RunConfig, argparse.Namespace]:
    """Parse reference-style CLI flags into a :class:`RunConfig`.

    Returns the config plus the raw namespace (for task-specific extras
    like pretraining task toggles).
    """
    ns = _build_parser().parse_args(argv)
    seed_list = (
        tuple(int(s) for s in ns.seed_list.split(",")) if ns.seed_list else ()
    )
    encoder = EncoderConfig(
        l_layers=ns.llayers,
        x_layers=ns.xlayers,
        r_layers=ns.rlayers,
        hidden_size=ns.hidden_size,
        num_heads=ns.num_heads,
        intermediate_size=ns.intermediate_size or 4 * ns.hidden_size,
        num_layers=ns.num_layers,
        hidden_dropout=ns.dropout,
        attention_dropout=ns.dropout,
    )
    cfg = RunConfig(
        mesh=MeshConfig(model_axis=ns.model_axis),
        model=ModelConfig(
            backbone=ns.backbone,
            encoder=encoder,
            project_size=ns.project_size,
            branched=ns.branched,
            branched_layers=ns.branched_layers,
            uq_as_class=ns.uq_as_class,
            vilt_patch_size=ns.vilt_patch_size,
            vilt_image_size=ns.vilt_image_size,
        ),
        train=TrainConfig(
            batch_size=ns.batch_size,
            epochs=ns.epochs,
            seed=ns.seed,
            strategy=ns.strategy,
            lr_w=ns.lr_w,
            update_weight_model=ns.update_weight_model,
            adv_steps=ns.adv_steps,
            adv_lr_txt=ns.adv_lr_txt,
            adv_lr_img=ns.adv_lr_img,
            adv_max_norm=ns.adv_max_norm,
            adv_kl_weight=ns.adv_kl_weight,
            adv_norm_type=ns.adv_norm_type,
            optim=OptimConfig(
                name=ns.optim, lr=ns.lr, bf16_moments=ns.bf16_moments
            ),
            dropout=ns.dropout,
            loss="mce" if ns.mce_loss else "bce",
            sample_pair=ns.sample_pair,
            mixup_mode=ns.mixup_mode,
            mixup_alpha=ns.mixup_alpha,
            mixup_beta=ns.mixup_beta,
            lam=ns.lam,
            lam1=ns.lam1,
            lam2=ns.lam2,
            m_in=ns.m_in,
            m_out=ns.m_out,
            chart=ns.chart,
            save_all=ns.save_all,
            use_bf16=not ns.fp32,
            eval_chunk=ns.eval_chunk,
            train_chunk=ns.train_chunk,
        ),
        ood=OODConfig(
            scorer=ns.scorer,
            tau=ns.tau,
            temperature=ns.temperature,
            noise=ns.noise,
            target_acc=ns.target_acc,
            seed_list=seed_list,
            ensemble_method=ns.ensemble_method,
            topk=ns.topk,
            mix_branched_score=ns.mix_branched_score,
            clip_path=ns.clip_path,
        ),
        data=DataConfig(
            data_root=ns.data_root,
            train_splits=ns.train,
            valid_splits=ns.valid,
            test_splits=ns.test,
            train_pos=ns.train_pos,
            train_neg=ns.train_neg,
            tiny=ns.tiny,
            fast=ns.fast,
            qa_sets=ns.qa_sets,
            vilt_resize=ns.vilt_resize,
            glove_path=ns.glove_path,
            num_workers=ns.num_workers,
            synthetic=ns.synthetic,
            feed_int8=ns.feed_int8,
            pixel_wire=ns.pixel_wire,
            vilt_randaug=not ns.no_randaug,
        ),
        output=ns.output,
        load=ns.load,
        load_lxmert=ns.load_lxmert,
        load_lxmert_qa=ns.load_lxmert_qa,
        load_gqa=ns.load_gqa,
        load_bert=ns.load_bert,
        teacher_path=ns.teacher_path,
        from_scratch=ns.from_scratch,
    )
    return cfg, ns
