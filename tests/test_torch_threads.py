"""One intra-op thread for each test module of the port.

The tier-1 run puts six pytest-xdist workers on the machine's cores.  A
PyTorch process starts one intra-op thread per core by default, so six
workers run up to six times as many threads as there are cores, and at
the tests' tiny shapes those threads contend for the cores instead of
working: a port test file took 3-30x its single-process time in the
six-worker run.  Every ``tests/test_torch_*.py`` imports
:func:`one_torch_thread`, a module-scoped autouse fixture: the module's
tests, its module fixtures and the subprocesses it starts (through
``OMP_NUM_THREADS``) run on one intra-op thread, and both settings are
restored after the module.  What the tests compute and check is the
same on any number of threads.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env


def test_a_port_module_and_its_subprocesses_run_on_one_thread():
    assert torch.get_num_threads() == 1
    out = subprocess.run([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                         capture_output=True, text=True, timeout=120, check=True).stdout
    assert out.strip() == "1"
