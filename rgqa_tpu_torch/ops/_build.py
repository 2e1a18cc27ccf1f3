"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``build/rgqa_tpu_torch/lib<name>_<digest>.so`` at the
repository root, where ``<digest>`` hashes the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  :func:`build_all` starts one nvcc per
source at once.  Nothing here runs at import time: the CPU tests import
every module on machines that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BuildResult", "SOURCES", "build", "build_all", "load_library", "NVCC_FLAGS"]

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "rgqa_tpu_torch"
SOURCES = (
    "fused_attention", "fused_attention_bwd", "fused_attention_dropout", "fused_attention_long",
    "fused_attention_long_bwd",
)

# sm_90a (not sm_90) so that later kernels may use wgmma/setmaxnreg;
# -Xptxas -v reports registers, shared memory and spills per kernel.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # compile time; 0.0 when an existing build was reused
    log: str  # nvcc's output (ptxas resource usage); empty when reused


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from rgqa_tpu_torch/csrc at first use"
    )


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, BuildResult]:
    """Compile each ``csrc/<name>.cu`` unless a build of this exact source,
    these headers and these flags exists; the compiles run side by side,
    one nvcc each.  Raises ``RuntimeError`` with nvcc's output on a failed
    compile."""
    results, running = {}, {}
    for name in names:
        src, out = _target(name)
        if out.exists():
            results[name] = BuildResult(out, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, src, out, tmp, time.perf_counter())
    failed = []
    for name, (proc, src, out, tmp, start) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            failed.append(f"nvcc failed with code {proc.returncode} on {src}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        results[name] = BuildResult(out, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists."""
    return build_all((name,))[name]


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one load per process."""
    return ctypes.CDLL(str(build(name).path))
