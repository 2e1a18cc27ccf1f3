"""The port's card scripts, as far as the CPU reaches them: ``chip_smoke.py``
refuses to run without a card or without the repository and imports
nothing of JAX, ``tools/time_attention.py`` refuses to run without a card
and takes its groups by name, and the forward profile's kernel classes."""

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
TIME_ATTENTION = os.path.join(REPO, "rgqa_tpu_torch", "tools", "time_attention.py")


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


@pytest.mark.parametrize("only", [[], ["short_fwd"], ["long", "short_bwd"], ["headfold"], ["epilogue"]])
def test_time_attention_needs_a_card(only):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the timing would run")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, TIME_ATTENTION, *(["--only", *only] if only else []), "--iters", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "us per call" not in proc.stdout


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_time_attention_library_call_computes_the_forward(rate):
    # The SDPA yardstick beside #1 / #4 takes the kernels' inputs as the
    # model hands them (column views of one QKV product, a (B, Skv) f32
    # bias) and computes attention_natural_ref's function.
    import importlib.util

    import torch

    from rgqa_tpu_torch.ops import attention as att

    spec = importlib.util.spec_from_file_location("time_attention", TIME_ATTENTION)
    ta = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ta)
    gen = torch.Generator().manual_seed(0)
    q, k, v = torch.randn(2, 20, 3 * ta.E, generator=gen).split(ta.E, -1)
    bias = torch.zeros(2, 20)
    bias[:, -5:] = -10000.0
    got = ta._sdpa(q, k, v, bias, rate)()
    assert got.shape == (2, ta.HEADS, 20, ta.E // ta.HEADS)
    if rate == 0.0:
        want = att.attention_natural_ref(q, k, v, bias, ta.HEADS)
        torch.testing.assert_close(got.transpose(1, 2).reshape(2, 20, ta.E), want, atol=1e-5, rtol=1e-5)
    else:  # dropout_p reaches the call: some probabilities dropped
        assert not torch.allclose(got, ta._sdpa(q, k, v, bias, 0.0)())


def test_time_attention_refuses_unknown_groups():
    proc = subprocess.run(
        [sys.executable, TIME_ATTENTION, "--only", "short"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2
    assert "invalid choice" in proc.stderr


@pytest.mark.parametrize(
    "name, cls",
    [
        ("(anonymous namespace)::fused_attention_bf16((anonymous namespace)::Args)", "attention kernel"),
        ("void (anonymous namespace)::fused_attention_bf16<true>((anonymous namespace)::Args)", "attention kernel"),
        ("void (anonymous namespace)::fused_attention_fwd_short_bf16<true, 6>((anonymous namespace)::Args)",
         "attention kernel"),
        ("void (anonymous namespace)::fused_attention_fwd_short_bf16<false, 4>((anonymous namespace)::Args)",
         "attention kernel"),
        ("void (anonymous namespace)::fused_attention_bwd_f32<false>((anonymous namespace)::Args)", "attention backward"),
        ("(anonymous namespace)::fused_attention_dbias_sum(float const*, float*, int, int, int)", "attention backward"),
        ("void (anonymous namespace)::fused_attention_bwd_short_bf16<true, 8>((anonymous namespace)::Args)",
         "attention backward"),
        ("void (anonymous namespace)::fused_attention_bwd_short_bf16<false, 6>((anonymous namespace)::Args)",
         "attention backward"),
        ("void (anonymous namespace)::fused_attention_long_bf16<24>((anonymous namespace)::Args)", "attention kernel"),
        ("void (anonymous namespace)::fused_attention_long_wgmma<2>((anonymous namespace)::Args)", "attention kernel"),
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


@pytest.mark.parametrize("flags", [[], ["--train"], ["--scorers"]], ids=["forward", "train", "scorers"])
def test_profile_forward_needs_a_card(flags):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the profile would run")
    from rgqa_tpu_torch.tools import profile_forward

    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_forward.main([*flags, "--iters", "1"])


def test_profile_serve_needs_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the profile would run")
    from rgqa_tpu_torch.tools import profile_serve

    with pytest.raises(RuntimeError, match="runs on a CUDA card"):
        profile_serve.main(["--records", "1"])


def test_profile_serve_runs_its_steps_on_the_cpu(tmp_path):
    """The serve profile's steps at a tiny size on the CPU: the packer and
    its decoder, LXMERT and ViLT throughput in one wave each (no device
    time there; the stream's window holds the wave's encode and scoring
    loop) and a latency tier, all numbers written to ``--out``."""
    import json

    from rgqa_tpu_torch.tools import profile_serve

    out = str(tmp_path / "serve.json")
    res = profile_serve.main(["--device", "cpu", "--tiny", "--tsv_rows", "4", "--records", "40",
                              "--batch", "16", "--latency_records", "3", "--interval", "0.01",
                              "--latency_batches", "8", "--out", out])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    assert res["decoder"]["rows"] == 4 and res["decoder"]["pack_mb_per_s"] > 0
    assert res["decoder"]["decode_mb_per_s"] > 0
    for name in ("throughput_lxmert", "throughput_vilt"):
        run = res[name]
        assert run["records"] == 40 and run["waves"] == 1 and run["device_ms"] is None
        assert run["encode_s"] > 0 and run["score_s"] > 0
        assert run["stream_s"] > run["encode_s"] + run["score_s"]
        assert run["q_per_s"] == pytest.approx(40 / run["stream_s"])
    assert res["latency_batch8"]["count"] == 3
