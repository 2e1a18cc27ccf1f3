"""Render cross-modal attention maps dumped by ``dump_attention`` (a copy
of ``rgqa_tpu/cli/plot_attention.py``; ``tests/test_torch_uniter_slice.py``
holds it to the original).

The reference ships a notebook (``gqa_vis_att.ipynb``) over the
``lxrt_vis`` fork's attention dumps; here ``ScoringMixin.dump_attention``
writes ``<dir>/<qid>.npz`` with ``lang2visn_{i}`` / ``visn2lang_{i}``
arrays per cross-modal layer, and this CLI turns them into heatmap PNGs
(one figure per qid: layers x heads grid, or head-averaged per layer).

Usage:
    python -m rgqa_tpu_torch.cli.plot_attention <npz_dir> [--out <dir>]
        [--qids q1,q2] [--direction lang2visn|visn2lang|both]
        [--head N | --mean-heads] [--layer N]

Pure host-side matplotlib — no device use.  matplotlib is imported in
the call that draws, and its absence raises a message naming it: the
machine with the card may have none, so the figures are drawn where
there is one, from the dumps.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

__all__ = ["plot_qid", "main"]


def _collect(data, direction: str) -> list[tuple[str, np.ndarray]]:
    """Ordered (name, (H, Sq, Skv)) arrays for one direction."""
    out = []
    i = 0
    while f"{direction}_{i}" in data:
        arr = np.asarray(data[f"{direction}_{i}"])
        out.append((f"{direction} L{i}", arr))
        i += 1
    return out


def plot_qid(
    npz_path: str,
    out_path: str,
    *,
    direction: str = "both",
    head: int | None = None,
    mean_heads: bool = False,
    layer: int | None = None,
    question: str | None = None,
) -> str:
    """One qid's npz -> one PNG (rows = layers, cols = heads)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plot_attention draws with matplotlib, which this Python lacks: run it where "
            "matplotlib is installed, on the .npz dumps"
        ) from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with np.load(npz_path) as data:
        dirs = (
            ["lang2visn", "visn2lang"] if direction == "both" else [direction]
        )
        panels: list[tuple[str, np.ndarray]] = []
        for d in dirs:
            for name, arr in _collect(data, d):
                li = int(name.rsplit("L", 1)[1])
                if layer is not None and li != layer:
                    continue
                if mean_heads:
                    panels.append((f"{name} (mean heads)", arr.mean(0)))
                elif head is not None:
                    panels.append((f"{name} h{head}", arr[head]))
                else:
                    for h in range(arr.shape[0]):
                        panels.append((f"{name} h{h}", arr[h]))
    if not panels:
        raise ValueError(
            f"no attention arrays matched in {npz_path} "
            f"(direction={direction!r}, layer={layer!r})"
        )
    ncols = min(len(panels), 6)
    nrows = -(-len(panels) // ncols)
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(2.2 * ncols, 2.0 * nrows), squeeze=False
    )
    for ax in axes.flat:
        ax.set_axis_off()
    for ax, (name, mat) in zip(axes.flat, panels):
        ax.imshow(mat, aspect="auto", cmap="viridis")
        ax.set_title(name, fontsize=6)
        ax.set_axis_on()
        ax.tick_params(labelsize=4)
    if question:
        fig.suptitle(question, fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("npz_dir", help="directory of <qid>.npz attention dumps")
    p.add_argument("--out", default=None, help="output dir (default: npz_dir)")
    p.add_argument("--qids", default=None, help="comma list (default: all)")
    p.add_argument(
        "--direction", default="both",
        choices=("both", "lang2visn", "visn2lang"),
    )
    p.add_argument("--head", type=int, default=None)
    p.add_argument("--mean-heads", action="store_true")
    p.add_argument("--layer", type=int, default=None)
    p.add_argument(
        "--questions", default=None,
        help="optional split JSON to title figures with the question text",
    )
    ns = p.parse_args(argv)
    out_dir = ns.out or ns.npz_dir
    os.makedirs(out_dir, exist_ok=True)

    qid2sent = {}
    if ns.questions:
        import json

        with open(ns.questions) as f:
            for row in json.load(f):
                qid2sent[str(row.get("question_id"))] = row.get("sent")

    if ns.qids:
        names = [q + ".npz" for q in ns.qids.split(",")]
    else:
        names = sorted(
            n for n in os.listdir(ns.npz_dir) if n.endswith(".npz")
        )
    written = []
    for name in names:
        qid = name[: -len(".npz")]
        png = os.path.join(out_dir, qid + ".png")
        plot_qid(
            os.path.join(ns.npz_dir, name), png,
            direction=ns.direction, head=ns.head,
            mean_heads=ns.mean_heads, layer=ns.layer,
            question=qid2sent.get(qid),
        )
        written.append(png)
    print(f"wrote {len(written)} figures to {out_dir}")
    return written


if __name__ == "__main__":
    main()
