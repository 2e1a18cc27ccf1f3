"""Data preparation (port of ``rgqa_tpu/cli/prepare_data.py``): the
reference download layout -> the data root the port reads.

    python -m rgqa_tpu_torch.cli.prepare_data \
        --tsv data/vg_gqa_imgfeat/vg_gqa_obj36.tsv \
        --json_dir data/gqa --vocab path/to/bert_vocab.txt \
        --out data_packed

Writes the same root as the JAX CLI: the split JSONs and answer vocabulary
of ``--json_dir`` (copied), ``vocab.txt`` and ``features/`` (the f32
feature pack, decoded once by ``data.tsv.pack_obj_tsv``), plus
``pixels_<size>_<mode>/`` under ``--pack_pixels`` (a ViLT pixel pack,
default 384 px; needs PIL), or with ``--pixel_transform clip``
``pixels_clip_<size>/`` (the CLIP scorer's rows, default 224 px; no
``--pixel_mode``).  It runs no device code, so it takes no
``--device``.  Not ported, and refused by name: ``--int8`` (the int8
feature pack).  Launched as N ranks (``torchrun``), rank 0 alone writes
the root; the others return None.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX CLI's flags; exits on what is not ported."""
    p = argparse.ArgumentParser(allow_abbrev=False)
    p.add_argument("--tsv", required=True, help="bottom-up-attention TSV")
    p.add_argument("--json_dir", required=True, help="dir with split JSONs + ans2label")
    p.add_argument(
        "--vocab", required=True,
        help="WordPiece vocab.txt (bert-base-uncased for LXMERT; the "
        "reference's UNITER path uses the bert-base-CASED vocab while "
        "still lowercasing input, so pass the cased vocab for UNITER)",
    )
    p.add_argument("--out", required=True)
    p.add_argument("--topk", type=int, default=None, help="limit images (--tiny/--fast)")
    p.add_argument("--num_boxes", type=int, default=36)
    p.add_argument("--int8", action="store_true", help="int8 feature pack: not ported (refused)")
    p.add_argument(
        "--pack_pixels", metavar="IMG_ROOT",
        help="also decode the JPEGs under IMG_ROOT once into a uint8 "
        "pixel pack, <out>/pixels_<size>_<mode> (needs PIL)",
    )
    p.add_argument("--pixel_size", type=int, default=None, help="default 384 (clip: 224)")
    p.add_argument("--pixel_mode", choices=("pad", "crop"), default=None, help="default pad")
    p.add_argument(
        "--pixel_transform", choices=("pixelbert", "clip"), default="pixelbert",
        help="pixelbert = ViLT rows (pad/crop + rect); clip = CLIP shortest-edge + "
        "center-crop rows for the CLIP scorer",
    )
    args = p.parse_args(argv)
    if args.int8:
        raise SystemExit("--int8 is not ported (the int8 feature pack); the port packs f32 features")
    if args.pixel_transform == "clip" and args.pixel_mode is not None:
        raise SystemExit("--pixel_mode applies to --pixel_transform pixelbert only (clip always "
                         "resizes shortest-edge + center crops)")
    return args


def main(argv=None) -> dict:
    """Write the data root; returns ``{"images": n, "pixels": n or None}``
    (None on a rank other than 0)."""
    args = parse_args(argv)
    if int(os.environ.get("RANK", "0") or 0) > 0:
        return None
    from rgqa_tpu_torch.data.tsv import pack_obj_tsv

    os.makedirs(args.out, exist_ok=True)
    for path in glob.glob(os.path.join(args.json_dir, "*.json")):
        shutil.copy(path, args.out)
    shutil.copy(args.vocab, os.path.join(args.out, "vocab.txt"))
    packed = pack_obj_tsv(
        args.tsv, os.path.join(args.out, "features"), topk=args.topk, num_boxes=args.num_boxes,
    )
    print(f"packed {len(packed)} images (f32) into {args.out}/features")
    done = {"images": len(packed), "pixels": None}

    if args.pack_pixels:
        from rgqa_tpu_torch.data.images import pack_pixels

        if args.pixel_transform == "clip":
            size, mode = args.pixel_size or 224, None
            pdir = os.path.join(args.out, f"pixels_clip_{size}")
        else:
            size, mode = args.pixel_size or 384, args.pixel_mode or "pad"
            pdir = os.path.join(args.out, f"pixels_{size}_{mode}")
        pack = pack_pixels(args.pack_pixels, pdir, size=size, mode=mode, transform=args.pixel_transform)
        print(f"packed {len(pack.img_ids)} images (uint8 pixels) into {pdir}")
        done["pixels"] = len(pack.img_ids)
    return done


if __name__ == "__main__":
    main()
