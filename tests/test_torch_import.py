"""Checkpoint-importer parity against the *actual* reference torch model.

Builds the reference ``lxrt.modeling`` LXMERT in-process (boto3 stubbed —
it's only used for checkpoint downloads), random-initializes it, imports
its ``state_dict`` through ``rgqa_tpu.checkpoint``, and checks:

1. every torch key is consumed by the key map (no silent drops),
2. the flax forward reproduces the torch forward numerically (pooled
   output + logits) — covering LN eps, erf-GELU, additive -10000 masks,
   the shared bidirectional cross-attention, and VisualFeatEncoder's
   ``(x+y)/2``.
"""

import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rgqa_tpu.config import EncoderConfig, ModelConfig
from rgqa_tpu.models.zoo import build_model, example_batch
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)


def _stub_boto3():
    import importlib.machinery

    for name in ("boto3", "botocore", "botocore.exceptions"):
        if name not in sys.modules:
            m = types.ModuleType(name)
            # transformers probes availability via importlib.util.find_spec;
            # a spec-less stub raises ValueError there.
            m.__spec__ = importlib.machinery.ModuleSpec(name, loader=None)
            sys.modules[name] = m
    if not hasattr(sys.modules["botocore.exceptions"], "ClientError"):
        sys.modules["botocore.exceptions"].ClientError = Exception
    sys.modules["boto3"].client = lambda *a, **k: None


@pytest.fixture(scope="module")
def ref_modeling(reference_dir):
    torch = pytest.importorskip("torch")
    _stub_boto3()
    sys.path.insert(0, str(reference_dir / "src"))
    try:
        from lxrt import modeling
    finally:
        sys.path.pop(0)
    return modeling


SHAPE = dict(l_layers=2, x_layers=2, r_layers=1)
ENC = EncoderConfig(
    hidden_size=64,
    num_heads=4,
    intermediate_size=128,
    vocab_size=300,
    visual_feat_dim=48,
    num_objects=5,
    **SHAPE,
)


def _build_ref_model(modeling, torch):
    modeling.VISUAL_CONFIG.l_layers = SHAPE["l_layers"]
    modeling.VISUAL_CONFIG.x_layers = SHAPE["x_layers"]
    modeling.VISUAL_CONFIG.r_layers = SHAPE["r_layers"]
    modeling.VISUAL_CONFIG.set_visual_dims(ENC.visual_feat_dim, 4)
    cfg = modeling.BertConfig(
        vocab_size_or_config_json_file=ENC.vocab_size,
        hidden_size=ENC.hidden_size,
        num_hidden_layers=2,
        num_attention_heads=ENC.num_heads,
        intermediate_size=ENC.intermediate_size,
    )
    torch.manual_seed(0)
    model = modeling.LXRTFeatureExtraction(cfg, mode="x")
    model.eval()
    return model


class TestLxmertImportParity:
    def test_key_map_covers_state_dict(self, ref_modeling):
        import torch

        from rgqa_tpu.checkpoint import lxmert_key_map

        model = _build_ref_model(ref_modeling, torch)
        sd_keys = set(model.state_dict().keys())
        mapped = {t for t, _, _ in lxmert_key_map(**SHAPE, answer_head=False)}
        mapped = {"bert." + t.split("bert.", 1)[1] for t in mapped if "bert." in t}
        missing = sorted(sd_keys - mapped)
        extra = sorted(mapped - sd_keys)
        assert not missing, f"torch keys not mapped: {missing[:8]}"
        assert not extra, f"mapped keys not in torch model: {extra[:8]}"

    def test_forward_parity(self, ref_modeling, tmp_path):
        import torch

        from rgqa_tpu.checkpoint import import_lxmert_gqa

        ref = _build_ref_model(ref_modeling, torch)
        # Re-randomize so no zeros survive (torch inits LN to 1/0 etc.).
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            for p in ref.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        torch.save(
            {"lxrt_encoder.model." + k: v for k, v in ref.state_dict().items()},
            tmp_path / "ref.pth",
        )

        cfg = ModelConfig(
            backbone="lxmert", encoder=ENC, num_answers=9, max_text_len=7
        )
        model, forward = build_model(cfg)
        batch = example_batch(cfg, batch_size=3, seed=5)
        # Exercise real masking: pad the tail of each row differently.
        batch["input_mask"][0, 4:] = 0
        batch["input_mask"][1, 6:] = 0
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        params = model.init(
            jax.random.PRNGKey(0),
            jb["input_ids"], jb["input_mask"], jb["segment_ids"],
            jb["feats"], jb["boxes"],
        )["params"]
        params, missing, unused = import_lxmert_gqa(
            params, str(tmp_path / "ref.pth"), **SHAPE
        )
        # Only the answer head (not in the encoder ckpt) may be missing.
        assert all("logit_fc" in m or "conf_fc" in m for m in missing)
        assert not unused, f"unused torch keys: {unused[:8]}"

        with torch.no_grad():
            pooled_t = ref(
                torch.tensor(batch["input_ids"], dtype=torch.long),
                torch.tensor(batch["segment_ids"], dtype=torch.long),
                torch.tensor(batch["input_mask"], dtype=torch.long),
                visual_feats=(
                    torch.tensor(batch["feats"]),
                    torch.tensor(batch["boxes"]),
                ),
            ).numpy()

        out = model.apply(
            {"params": jax.tree_util.tree_map(jnp.asarray, params)},
            jb["input_ids"], jb["input_mask"], jb["segment_ids"],
            jb["feats"], jb["boxes"],
            method=lambda m, *a: m.lxmert(*a),
        )
        pooled_j = np.asarray(out["pooled"])
        np.testing.assert_allclose(pooled_j, pooled_t, rtol=2e-4, atol=2e-5)
