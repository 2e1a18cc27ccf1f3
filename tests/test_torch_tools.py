"""The port's card scripts, as far as the CPU reaches them: ``chip_smoke.py``
refuses to run without a card or without the repository and imports
nothing of JAX, and the forward profile's kernel classes."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

import pytest

from rgqa_tpu_torch.tools.profile_forward import classify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def test_chip_smoke_imports_nothing_of_jax():
    tree = ast.parse(open(SMOKE).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "rgqa_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "orbax", "rgqa_tpu"}


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    if not alone and __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the smoke would run")
    cwd = REPO
    if alone:
        shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize(
    "name, cls",
    [
        ("(anonymous namespace)::fused_attention_bf16((anonymous namespace)::Args)", "attention kernel"),
        ("void (anonymous namespace)::fused_attention_bf16<true>((anonymous namespace)::Args)", "attention kernel"),
        ("void (anonymous namespace)::fused_attention_bwd_f32<false>((anonymous namespace)::Args)", "attention backward"),
        ("(anonymous namespace)::fused_attention_dbias_sum(float const*, float*, int, int, int)", "attention backward"),
        ("void (anonymous namespace)::fused_attention_bwd_short_bf16<true, 8>((anonymous namespace)::Args)",
         "attention backward"),
        ("void (anonymous namespace)::fused_attention_bwd_short_bf16<false, 6>((anonymous namespace)::Args)",
         "attention backward"),
        ("void (anonymous namespace)::fused_attention_long_bf16<24>((anonymous namespace)::Args)", "attention kernel"),
        ("void (anonymous namespace)::long_bwd_rows_bf16<24>((anonymous namespace)::Args)", "attention backward"),
        ("(anonymous namespace)::long_bwd_keys_bf16((anonymous namespace)::Args)", "attention backward"),
        ("(anonymous namespace)::long_bwd_keys_f32((anonymous namespace)::Args)", "attention backward"),
        ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_cublas", "matmul"),
        ("nvjet_tst_128x64_64x8_1x2_h_bz_TNN", "matmul"),
        ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16, float>", "layer norm"),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl>", "gelu"),
        ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<8, float>", "softmax"),
        ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<c10::BFloat16>", "weight concat"),
        ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda>", "copy / cast"),
        ("Memcpy HtoD (Pageable -> Device)", "memcpy / memset"),
        ("void at::native::indexSelectLargeIndex<c10::BFloat16, long>", "other"),
    ],
)
def test_profile_kernel_classes(name, cls):
    assert classify(name) == cls
