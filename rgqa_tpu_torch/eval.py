"""Prediction and rejection scoring over a split (port of
``rgqa_tpu/eval.py``: ``predict``, ``evaluate``, ``topk_predict``,
``oracle_score``, ``dump_attention``, ``make_scorer``,
``score_split``, ``ood_evaluate``, ``gated_ood_evaluate``,
``ensemble_ood_evaluate``, ``clip_ood_evaluate``, ``match_ood_evaluate``,
``coverage_ood_evaluate``,
``fit_maha_estimator``, ``get_pseudo_labels`` and ``predict_with_thresh``;
``score_rows``, the answers by row, for the serving waves).

``ScoringMixin`` expects the host class to provide ``cfg``, ``device``,
``mesh``, ``model``, ``forward``, ``model_cfg``, ``label2ans``,
``train_set``, ``output``, ``features``, ``_encode``, ``_on_main`` and
``load``, i.e. :class:`rgqa_tpu_torch.runner.GQARunner`.

Data parallel (the host's ``mesh`` of N ranks): :meth:`ScoringMixin.
_map_eval` scores this rank's rows of each padded global batch and
gathers every rank's outputs in global order, so every scorer, metric
and decision sees the whole split on every rank, as one process would;
rank 0 alone writes the dumps and caches.  The Mahalanobis fit sums over
the gathered features of the whole train split, and every rank then
reads the estimator that rank 0 cached; ODIN's input gradient
stays per row; MC-dropout draws from the rank's own stream.
The metrics and the prediction-JSON dump are ``rgqa_tpu_torch.metrics``,
the port's copy of the JAX package's.  ``predict`` stands in for the JAX
package's ``train/step.py::make_eval_step`` as well (through
``make_msp_scorer``).

The feed hands every scorer exact f32 RoI feats (the models cast them to
their compute dtype inside the first product).  The JAX feed casts them
to bf16 on the host for a bf16 model unless a scorer carries
``needs_f32_inputs`` (ODIN, Mahalanobis and its fit); the port keeps the
flag on those scorers and never casts.  BUTD is the exception: it
computes in f32 under ``--bf16`` too, so the only bf16 rounding of its
run is the JAX feed's, which ``_map_eval`` makes on the device (the
feats rounded to bf16 and back for every step function without
``needs_f32_inputs``).  So does the match scorer's f32 pretraining model
(its step carries ``bf16_feed``).

The CLIP scorer reads images, not RoI feats: ``clip_ood_evaluate`` feeds
it uint8 rows from a CLIP pixel pack beside the image root when one
matches (``pixels_clip_<size>/``, checked for transform, size and source;
a synthetic root writes its own), else JPEGs decoded with PIL; where it
can do neither it raises, naming the pack and the ``prepare_data``
command that builds it.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Iterator, Optional

import numpy as np
import torch

from rgqa_tpu_torch.metrics import ClosedSetEvaluator, RGQAEvaluator, dump_predictions
from rgqa_tpu_torch.data.batching import batch_iterator, device_prefetch
from rgqa_tpu_torch.data.dataset import EncodedGQA, GQADataset
from rgqa_tpu_torch.data.images import GQAImageSource, PixelPack
from rgqa_tpu_torch.data.synthetic import BASE_IMAGES, make_synthetic_pixel_pack
from rgqa_tpu_torch.parallel.mesh import gather_rows
from rgqa_tpu_torch.scorers import (
    apply_tau,
    calibrate_tau,
    coverage_scores,
    ensemble_merge,
    fit_estimator,
    load_object_vocab,
    make_match_scorer,
    make_msp_scorer,
    make_scorer,
)
from rgqa_tpu_torch.scorers.maha import MahaEstimator, estimator_from_numpy

__all__ = ["ScoringMixin"]


class ScoringMixin:
    """Closed-set prediction, rejection scoring and calibrated-threshold
    evaluation."""

    def _map_eval(
        self, encoded: EncodedGQA, step_fn, select: tuple[str, ...]
    ) -> Iterator[tuple[list, dict, int]]:
        """Run ``step_fn(batch)`` over a split; yield ``(qids, {key:
        numpy array}, real)``.  Outputs are fetched one batch behind the
        dispatch front, so the host's copy of batch i overlaps the
        device's work on batch i+1.  Under several ranks each scores its
        rows and the outputs are every rank's rows, gathered."""
        batches = device_prefetch(
            batch_iterator(encoded, self.cfg.train.batch_size, mesh=self.mesh), self.device
        )
        round_feats = (self.cfg.train.use_bf16 and not getattr(step_fn, "needs_f32_inputs", False)
                       and (self.model_cfg.backbone == "butd" or getattr(step_fn, "bf16_feed", False)))
        pending = None
        for qids, batch, real in batches:
            if round_feats:  # the JAX feed's bf16 feats, promoted to f32 in the model
                batch = dict(batch, feats=batch["feats"].to(torch.bfloat16).float())
            out = step_fn(batch)
            current = (qids, {k: gather_rows(self.mesh, out[k]) for k in select}, real)
            if pending is not None:
                yield _fetch(pending)
            pending = current
        if pending is not None:
            yield _fetch(pending)

    def make_scorer(self, name: Optional[str] = None):
        """The configured scorer (``--scorer`` and the ``cfg.ood``
        options), built once per name and runner; ``maha`` fits (or
        reads) its estimator first."""
        ocfg = self.cfg.ood
        name = name or ocfg.scorer or "msp"
        cache = self.__dict__.setdefault("_scorer_cache", {})
        if name not in cache:
            opts = dict(
                temperature=ocfg.temperature,
                noise=ocfg.noise,
                topk=2,
                seed_list=ocfg.seed_list or (0, 1, 2, 3, 4),
                mix=ocfg.mix_branched_score,
                mesh=self.mesh,
            )
            if name == "maha":
                opts["estimator"] = self.fit_maha_estimator()
            cache[name] = make_scorer(name, self.forward, **opts)
        return cache[name]

    def predict(self, encoded: EncodedGQA, dump: Optional[str] = None) -> dict:
        """Closed-set predictions ``{qid: answer}``."""
        quesid2ans = {}
        for qids, out, real in self._map_eval(encoded, self.make_scorer("msp"), ("label",)):
            for qid, label in zip(qids, out["label"][:real]):
                quesid2ans[qid] = self.label2ans[int(label)]
        if dump:
            self._on_main(ClosedSetEvaluator(encoded.dataset.qid2label).dump_result, quesid2ans, dump)
        return quesid2ans

    def evaluate(self, encoded: EncodedGQA) -> float:
        """Closed-set soft accuracy on a labeled split."""
        return ClosedSetEvaluator(encoded.dataset.qid2label).evaluate(self.predict(encoded))

    def topk_predict(self, encoded: EncodedGQA, k: int = 4, dump: Optional[str] = None) -> float:
        """Top-k oracle accuracy: the gold answer counts as correct when it
        is among the ``k`` highest f32 logits (``gqa.py:196-217``)."""

        def topk_step(batch):
            with torch.inference_mode():
                logits = self.forward(batch, deterministic=True)["logits"].float()
                return {"topk": torch.topk(logits, k, dim=-1).indices}

        quesid2ans = {}
        for qids, out, real in self._map_eval(encoded, topk_step, ("topk",)):
            for qid, proposals in zip(qids, out["topk"][:real]):
                label = encoded.dataset.id2datum[qid].get("label") or {}
                gold = next(iter(label), None)
                names = [self.label2ans[int(p)] for p in proposals]
                quesid2ans[qid] = gold if gold in names else names[0]
        evaluator = ClosedSetEvaluator(encoded.dataset.qid2label)
        if dump:
            self._on_main(evaluator.dump_result, quesid2ans, dump)
        return evaluator.evaluate(quesid2ans)

    @staticmethod
    def oracle_score(encoded: EncodedGQA) -> float:
        """Upper-bound accuracy from the targets alone (``gqa.py:244-253``)."""
        quesid2ans = {}
        for qid in encoded.question_ids:
            label = encoded.dataset.id2datum[qid].get("label") or {}
            quesid2ans[qid] = max(label, key=label.get) if label else ""
        return ClosedSetEvaluator(encoded.dataset.qid2label).evaluate(quesid2ans)

    def dump_attention(self, encoded: EncodedGQA, out_dir: str, limit: Optional[int] = None) -> int:
        """Dump LXMERT's cross-modal attention maps per question
        (reference ``gqa_vis_att.py:263-299``, through ``output_probs``):
        ``<out_dir>/<qid>.npz`` with ``lang2visn_{i}`` / ``visn2lang_{i}``
        (heads, Sq, Skv) arrays per cross layer, in the compute dtype's
        values as f32.  Returns the count written (at most ``limit``)."""
        if self.model_cfg.backbone != "lxmert":
            raise NotImplementedError(
                "dump_attention reads LXMERT's cross-modal attention; "
                f"--backbone {self.model_cfg.backbone} has none")
        if self.mesh.is_main:
            os.makedirs(out_dir, exist_ok=True)
        n_layers = self.model_cfg.encoder.x_layers

        def viz_step(batch):
            with torch.inference_mode():
                probs = self.forward(batch, deterministic=True, output_probs=True)["x_attention_probs"]
            return {f"{name}_{i}": p.float() for i, pair in enumerate(probs)
                    for name, p in zip(("lang2visn", "visn2lang"), pair)}

        keys = tuple(f"{name}_{i}" for i in range(n_layers) for name in ("lang2visn", "visn2lang"))
        written = 0
        for qids, out, real in self._map_eval(encoded, viz_step, keys):
            for row, qid in enumerate(qids[:real]):
                if self.mesh.is_main:  # every rank counts alike and stops at the same row
                    np.savez(os.path.join(out_dir, f"{qid}.npz"), **{key: out[key][row] for key in keys})
                written += 1
                if limit and written >= limit:
                    return written
        return written

    def score_rows(self, encoded: EncodedGQA, scorer=None) -> list:
        """``[(answer, confidence)]``, one per encoded row in row order
        (rows that share a question id keep their own answers)."""
        scorer = scorer or self.make_scorer()
        rows = []
        for _, out, real in self._map_eval(encoded, scorer, ("label", "score")):
            for label, score in zip(out["label"][:real], out["score"][:real]):
                rows.append((self.label2ans[int(label)], float(score)))
        return rows

    def score_split(self, encoded: EncodedGQA, scorer=None) -> dict:
        """``{qid: (answer, confidence)}`` over a split."""
        return dict(zip(encoded.question_ids, self.score_rows(encoded, scorer)))

    def _rejection_results(self, encoded: EncodedGQA, quesid2ans: dict, dump: Optional[str]) -> dict:
        results = RGQAEvaluator(encoded.dataset.qid2label, tau=self.cfg.ood.tau).evaluate_quesid2ans(
            quesid2ans
        )
        if dump:
            self._on_main(dump_predictions, quesid2ans, dump)
        return results

    def ood_evaluate(
        self, encoded: EncodedGQA, dump: Optional[str] = None, scorer=None
    ) -> dict:
        """Rejection evaluation with the configured scorer
        (``gqa_conf.py:297-333``): AUAF / FF95 / FACC and the rest of the
        RGQA metric dict; ``dump`` writes the prediction JSON."""
        return self._rejection_results(encoded, self.score_split(encoded, scorer=scorer), dump)

    def gated_ood_evaluate(self, encoded: EncodedGQA, answerer, dump: Optional[str] = None) -> dict:
        """Separate-detector evaluation (``gqa_separate.py:200-234``):
        this runner's one-logit model scores answerability (its sigmoid);
        ``answerer``, a runner with a GQA model, gives the answers."""
        answers = answerer.predict(answerer._encode(encoded.dataset))
        quesid2ans = {}
        for qids, out, real in self._map_eval(encoded, self.make_scorer("msp"), ("score",)):
            for qid, score in zip(qids, out["score"][:real]):
                quesid2ans[qid] = (answers[qid], float(score))
        return self._rejection_results(encoded, quesid2ans, dump)

    def ensemble_ood_evaluate(
        self, encoded: EncodedGQA, ckpt_paths: list[str], dump: Optional[str] = None,
    ) -> dict:
        """Mean / product ensemble over checkpoints (``gqa_ensemble.py``;
        ``--ensemble_method``): each ``.pth`` is loaded into this runner's
        model in turn and scored with MSP; the sigmoid vectors merge on
        the host's copy."""
        msp = make_msp_scorer(self.forward)
        all_qids: list[str] = []
        prob_sets = []
        for path in ckpt_paths:
            self.load(path)
            probs, qids_seen = [], []
            for qids, out, real in self._map_eval(encoded, msp, ("probs",)):
                probs.append(out["probs"][:real])
                qids_seen.extend(qids[:real])
            prob_sets.append(np.concatenate(probs, 0))
            all_qids = qids_seen
        merged = ensemble_merge(
            [torch.from_numpy(p) for p in prob_sets], self.cfg.ood.ensemble_method
        )
        quesid2ans = {
            qid: (self.label2ans[int(label)], float(score))
            for qid, label, score in zip(all_qids, merged["label"].numpy(), merged["score"].numpy())
        }
        return self._rejection_results(encoded, quesid2ans, dump)

    def _clip_pack(self, owner, image_root: str) -> tuple[Optional[PixelPack], Optional[str]]:
        """(the CLIP pack that may stand in for ``image_root``'s JPEGs or
        None, the pack's directory or None) for a scorer ``owner``: only a
        scorer that declares ``consumes_uint8_rows`` takes pack rows, and
        only from ``<root>/pixels_clip_<its image_size>/`` built from this
        very image root with the clip transform at that size.  A synthetic
        root without the pack gets it written from its base images."""
        size = getattr(owner, "image_size", None)
        if not size or not getattr(owner, "consumes_uint8_rows", False):
            return None, None
        root = os.path.dirname(os.path.abspath(image_root))
        pack_dir = os.path.join(root, f"pixels_clip_{size}")
        meta = os.path.join(pack_dir, "meta.json")

        def write_pack():
            if self.cfg.data.synthetic and not os.path.isfile(meta) and os.path.isfile(
                os.path.join(root, BASE_IMAGES)
            ):
                make_synthetic_pixel_pack(root, size, transform="clip")

        self._on_main(write_pack)
        if os.path.isfile(meta):
            pack = PixelPack(pack_dir)
            if pack.transform == "clip" and pack.size == size and pack.matches_source(image_root):
                return pack, pack_dir
        return None, pack_dir

    def clip_ood_evaluate(
        self, encoded: EncodedGQA, similarity, image_root: str, dump: Optional[str] = None,
        batch_size: int = 32,
    ) -> dict:
        """CLIP-score rejection (``gqa_clip.py:76-110``): answers from this
        model's argmax, confidence = the image-question cosine from
        ``similarity(images, texts) -> scores`` (usually a bound
        ``scorers.clip.ClipScorer.scores``), ``batch_size`` questions a
        call.  Images come from a matching CLIP pixel pack
        (:meth:`_clip_pack`) where it holds them, else from the JPEGs
        under ``image_root`` through PIL; a question whose image neither
        can give raises before anything is scored."""
        owner = getattr(similarity, "__self__", similarity)
        pack, pack_dir = self._clip_pack(owner, image_root)
        ds = encoded.dataset
        qids = list(encoded.question_ids)
        img_ids = [ds.id2datum[q]["img_id"] for q in qids]
        source = GQAImageSource(image_root)
        decode = sorted({i for i in img_ids if pack is None or i not in pack})
        if decode:
            _check_decodable(decode, source, image_root, pack_dir, getattr(owner, "image_size", None))
        answers = self.predict(encoded)
        quesid2ans = {}
        for s in range(0, len(qids), batch_size):
            chunk = qids[s : s + batch_size]
            imgs = [pack.load_u8(i)[0] if pack is not None and i in pack else decode_rgb(source, i)
                    for i in img_ids[s : s + batch_size]]
            scores = similarity(imgs, [ds.id2datum[q]["sent"] for q in chunk])
            for qid, score in zip(chunk, scores):
                quesid2ans[qid] = (answers[qid], float(score))
        return self._rejection_results(encoded, quesid2ans, dump)

    def match_ood_evaluate(self, encoded: EncodedGQA, pretrain_forward, dump: Optional[str] = None) -> dict:
        """LXMERT cross-modal match rejection (``gqa_lxrcap.py:98-120``):
        answers from this fine-tuned model, confidence =
        ``softmax(matched)[:, 1]`` in f32 of the pretraining model behind
        ``pretrain_forward`` (``models.zoo.load_pretraining``'s adapter),
        fed the JAX feed's bf16-rounded feats under ``--bf16``."""
        answers = self.predict(encoded)
        quesid2ans = {}
        for qids, out, real in self._map_eval(encoded, make_match_scorer(pretrain_forward), ("score",)):
            for qid, score in zip(qids, out["score"][:real]):
                quesid2ans[qid] = (answers[qid], float(score))
        return self._rejection_results(encoded, quesid2ans, dump)

    def coverage_ood_evaluate(self, encoded: EncodedGQA, objects_vocab_path: str,
                              dump: Optional[str] = None) -> dict:
        """FRCNN object-coverage rejection (``gqa_fasterrcnn.py:105-133``):
        answers from this model's MSP argmax (:meth:`predict`), confidence
        1.0 iff every noun stem of the question names an object detected
        in its image (the pack's ``objects_id`` row against the stemmed
        ``objects_vocab_path``), else 0.0; the dump at full precision."""
        vocab = load_object_vocab(objects_vocab_path)
        answers = self.predict(encoded)
        qids = list(encoded.question_ids)
        sents = [encoded.dataset.id2datum[q]["sent"] for q in qids]
        objects = [np.asarray(self.features.objects_id[r]) for r in encoded.img_row]
        scores = coverage_scores(sents, objects, vocab)
        quesid2ans = {qid: (answers[qid], float(s)) for qid, s in zip(qids, scores)}
        return self._rejection_results(encoded, quesid2ans, dump)

    def fit_maha_estimator(self) -> MahaEstimator:
        """Per-class means and the shared precision over the train split
        (``gqa_maha.py:120-189``; an evaluation runner encodes it here),
        cached in ``<output>/sample_estimates.pkl``
        as the JAX package writes it (numpy ``{"mean", "precision"}``), so
        a cache from either package loads in the other.  The pooled
        features come from deterministic forwards (eval mode) on exact
        f32 feats and f32 weights (under bf16 compute a runner built with
        ``f32_weights=True`` keeps them, as the JAX evaluate CLI's
        training runner does): every later run reads the cache, so a fit
        from bf16 serving weights is refused."""
        cache = os.path.join(self.output, "sample_estimates.pkl")
        if os.path.exists(cache):
            return _read_estimates(cache, self.device)
        dtypes = {p.dtype for p in self.model.parameters()}
        if dtypes != {torch.float32}:
            raise RuntimeError(
                f"the Mahalanobis fit is cached for later runs and needs f32 weights, this model's "
                f"are {sorted(map(str, dtypes))}: build the runner with f32_weights=True (bf16 "
                "compute on f32 weights), as the evaluate CLI does for --scorer maha"
            )
        train_set = self.train_set
        if train_set is None:  # an evaluation runner encodes the split for the fit alone
            data = self.cfg.data
            train_set = self._encode(GQADataset(data.data_root, data.train_splits, add_uq=True))

        def batches():
            # Pooled features and targets stay on the device: the fit's
            # sums run behind the forwards, with no sync until its end.
            # Under several ranks: every rank's rows, gathered.
            items = batch_iterator(train_set, self.cfg.train.batch_size, with_target=True, mesh=self.mesh)
            for _, batch, real in device_prefetch(items, self.device):
                with torch.no_grad():
                    pooled = self.forward(batch, deterministic=True)["pooled"]
                yield gather_rows(self.mesh, pooled)[:real], gather_rows(self.mesh, batch["target"])[:real]

        mcfg = self.model_cfg
        est = fit_estimator(
            batches(), num_classes=mcfg.num_answers,
            feat_dim=mcfg.butd_hidden_dim if mcfg.backbone == "butd" else mcfg.encoder.hidden_size,
            device=self.device,
        )
        self._on_main(_write_estimates, cache, est)
        # Under several ranks each rank reads back what rank 0 cached.
        return est if self.mesh.world == 1 else _read_estimates(cache, self.device)

    def get_pseudo_labels(self, encoded: EncodedGQA, dump: Optional[str] = None) -> list[dict]:
        """Teacher-label a split: each row's label becomes the scorer's
        answer with its confidence (``gqa_conf.py:335-353``)."""
        quesid2ans = self.score_split(encoded)
        rows = []
        for qid in encoded.question_ids:
            datum = dict(encoded.dataset.id2datum[qid])
            ans, score = quesid2ans[qid]
            datum["label"] = {ans: float(score)}
            rows.append(datum)
        if dump:
            self._on_main(_write_pseudo_labels, rows, dump)
        return rows

    def predict_with_thresh(self, encoded: EncodedGQA, dump: Optional[str] = None) -> dict:
        """Calibrate tau at ``--target_acc`` on a labeled split, then
        threshold (``gqa_conf.py:262-295``).  The dump holds ``{qid:
        [answer, confidence]}`` at full precision, as the reference
        writes it; the JAX package rounds it to 4 dp, a fault the port
        does not copy."""
        if self.cfg.ood.target_acc is None:
            raise ValueError("predict_with_thresh needs --target_acc")
        quesid2ans = self.score_split(encoded)
        targets, preds, scores = [], [], []
        for qid, (ans, score) in quesid2ans.items():
            label = encoded.dataset.id2datum[qid].get("label") or {}
            targets.append(next(iter(label), "UQ"))
            preds.append(ans)
            scores.append(score)
        tau = calibrate_tau(targets, preds, scores, self.cfg.ood.target_acc)
        out = apply_tau(quesid2ans, tau)
        if dump:
            self._on_main(_write_json, {q: [ans, float(score)] for q, (ans, score) in out.items()}, dump)
        return {"tau": tau, "quesid2ans": out}


def _read_estimates(cache: str, device) -> MahaEstimator:
    with open(cache, "rb") as f:
        data = pickle.load(f)
    return estimator_from_numpy(data["mean"], data["precision"], device)


def _write_estimates(cache: str, est: MahaEstimator) -> None:
    with open(cache, "wb") as f:
        pickle.dump(
            {"mean": est.class_mean.cpu().numpy(), "precision": est.precision.cpu().numpy()},
            f, protocol=pickle.HIGHEST_PROTOCOL,
        )


def _write_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def _write_pseudo_labels(rows: list, dump: str) -> None:
    _write_json(rows, dump)
    print(f"{len(rows)} pseudo data have been saved in {dump}.")


def _check_decodable(img_ids, source, image_root: str, pack_dir: Optional[str], size,
                     what: str = "--scorer clip") -> None:
    """Raise unless PIL and every JPEG of ``img_ids`` are there; the
    message names ``what`` wants the pixels."""
    missing = []
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        missing.append("PIL")
    absent = [i for i in img_ids if i not in source]
    if absent:
        missing.append(f"{len(absent)} JPEGs under {image_root} (e.g. {absent[0]}.jpg)")
    if not missing:
        return
    where = (f"no CLIP pixel pack {pack_dir} (size {size}, built from {image_root}) holds them" if pack_dir
             else "this scorer takes no pixel pack")
    raise RuntimeError(
        f"{what} has no pixels for {len(img_ids)} images: {where}, and decoding "
        f"the JPEGs needs {', '.join(missing)}. Build the pack where PIL and the JPEGs are: python -m "
        f"rgqa_tpu_torch.cli.prepare_data --tsv <tsv> --json_dir <json_dir> --vocab <vocab.txt> "
        f"--out {os.path.dirname(os.path.abspath(image_root))} --pack_pixels {image_root} "
        f"--pixel_transform clip --pixel_size {size or 224}"
    )


def decode_rgb(source: GQAImageSource, img_id: str):
    from PIL import Image

    with Image.open(source.path(img_id)) as im:
        return im.convert("RGB")


def _fetch(item):
    qids, out, real = item
    return qids, {k: v.cpu().numpy() for k, v in out.items()}, real
