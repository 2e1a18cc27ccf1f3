"""Training CLI (port of ``rgqa_tpu/cli/train.py``: every ``--strategy``).

Fine-tunes LXMERT, UNITER (``--backbone uniter``; ``--loadLXMERT`` takes
a pretrained UNITER encoder), ViLT (``--backbone vilt``) or BUTD
(``--backbone butd``; f32 whatever ``--bf16`` says, its dropouts the
model's fixed 0.2 / 0.5) on GQA with the JAX CLI's flags (BCE loss,
BertAdam, global clip 5.0, ``--sample_pair`` for RP pseudo-UQ pairs,
``--dropout`` on attention and hidden activations; ViLT has hidden
dropout only, and train-time randaug unless ``--no_randaug``).
``--strategy separate`` trains a one-logit detector, and ``--backbone
caps --strategy caption`` the Q-C caption matcher (``--load_bert``: a
local HF BERT to start from), both with the binary loss against the
answerable indicator.  The strategy scripts' flags
(``scripts/*/train/{mixup,branched,energy,ood_finetune}.sh``) pass
through to the runner's step: ``--mixup_mode`` (``--mixup_alpha``,
``--mixup_beta``, ``--lam1``, ``--lam2``; the RoI swap, perturb, the
weighted sums and TreeMix), ``--mceLoss``, ``--scorer energy --m_in
--m_out`` (the energy hinge), ``--branched`` / ``--branched_layer``
(LXMERT's, and BUTD's ``--branched``), ``--uq_as_class`` and
``--chart``.  The strategy scripts with a step of their own
(``scripts/lxmert/train/{adv,resampling,poem,woods,distill_online,
weight}.sh``): ``--strategy adv`` (VILLA, LXMERT only: ``--adv_steps``,
``--adv_lr_txt``, ``--adv_lr_img``, ``--adv_max_norm``,
``--adv_kl_weight``, ``--norm_type``), ``resampling`` / ``poem`` /
``woods`` (``--train_pos``, ``--train_neg``, ``--lr_w``; no resume),
``distill_online`` (``--teacher_path`` a ``.pth``, or the path less its
``.pth``; ``--lam``, ``--mixup_mode``), ``weight`` (``--clip_path`` and
``--temperature``; without a CLIP checkpoint the root's captions, else
uniform weights; with ``--update_weight_model`` CLIP is trained beside
the answerer and written as ``LAST_clip.pth`` and ``clip_params/``).  ``--optim`` bert (``--bf16_moments``), adam, adamw,
adamax, sgd or rms; ``--loadLXMERT`` / ``--loadLXMERTQA`` start LXMERT
from a reference ``model_LXRT.pth`` (``--loadLXMERTQA`` matches the
answer head through ``<data_root>/all_ans.json`` or
``data/lxmert/all_ans.json``).  It writes ``BEST.pth``, ``LAST.pth`` (the reference
``.pth`` format of the backbone), ``LAST.state.pt`` and ``log.log``
(and with ``--chart`` ``chart/epoch_<n>.pkl``) under ``--output``, and
prints ``{"final_loss", "valid"}``.  It runs on the card (``--device cuda``, the default;
raises without one) unless given ``--device cpu``.

Examples:
    python -m rgqa_tpu_torch.cli.train --synthetic --data_root /tmp/gqa \
        --sample_pair --epochs 1 --batchSize 32 --output /tmp/gqa_snap
    python -m rgqa_tpu_torch.cli.train --backbone uniter --synthetic \
        --data_root /tmp/gqa --sample_pair --epochs 1 --batchSize 32 \
        --output /tmp/gqa_uniter_snap
    # ViLT-B/32 from the synthetic root's pixel pack (randaug needs PIL
    # and JPEGs):
    python -m rgqa_tpu_torch.cli.train --backbone vilt --synthetic \
        --data_root /tmp/gqa_vilt --sample_pair --no_randaug --epochs 1 \
        --batchSize 32 --output /tmp/gqa_vilt_snap
    python -m rgqa_tpu_torch.cli.train --backbone butd --synthetic \
        --data_root /tmp/gqa --sample_pair --epochs 1 --batchSize 32 \
        --output /tmp/gqa_butd_snap
    python -m rgqa_tpu_torch.cli.train --synthetic --data_root /tmp/gqa \
        --mixup_mode mixup_v1 --mixup_beta 5 --epochs 1 --batchSize 32 \
        --output /tmp/gqa_mixup_snap
    python -m rgqa_tpu_torch.cli.train --backbone caps --strategy caption \
        --synthetic --data_root /tmp/gqa --epochs 1 --batchSize 32 \
        --output /tmp/gqa_caps_snap
    python -m rgqa_tpu_torch.cli.train --synthetic --data_root /tmp/gqa \
        --strategy resampling --train_pos GQAUQ_train_questions_unsup \
        --train_neg GQAUQ_train_questions_unsup_hard --lr_w 0.1 --epochs 1 \
        --batchSize 32 --output /tmp/gqa_resampling_snap
    python -m rgqa_tpu_torch.cli.train --synthetic --data_root /tmp/gqa \
        --strategy distill_online --teacher_path /tmp/gqa_snap/BEST \
        --mixup_mode mixup_v1 --epochs 1 --batchSize 32 --output /tmp/gqa_distill_snap
    # The CLIP weight model trained beside the answerer (CLIP_DIR: a local
    # HF CLIP checkpoint; pixels from the root's CLIP pack):
    python -m rgqa_tpu_torch.cli.train --synthetic --data_root /tmp/gqa \
        --strategy weight --update_weight_model --clip_path CLIP_DIR \
        --epochs 1 --batchSize 32 --output /tmp/gqa_weight_model_snap

Data parallel over N ranks (``--batchSize`` stays the global batch; the
world must divide it)::

    python -m torch.distributed.run --nproc_per_node N -m rgqa_tpu_torch.cli.train ...

one card a rank (NCCL), or with ``--device cpu`` N processes over gloo.
"""

from __future__ import annotations

import json

from rgqa_tpu_torch.config import parse_cli
from rgqa_tpu_torch.parallel import initialize_distributed
from rgqa_tpu_torch.runner import GQARunner


def main(argv=None) -> dict:
    cfg, ns = parse_cli(argv)
    device = initialize_distributed(ns.device) or ns.device
    runner = GQARunner(cfg, device=device)
    history = runner.train()
    if runner.mesh.is_main:
        print(json.dumps({"final_loss": history["loss"][-1] if history["loss"] else None,
                          "valid": history["valid"]}))
    return history


if __name__ == "__main__":
    main()
