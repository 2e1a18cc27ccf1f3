"""The recipe matrix through the port (``rgqa_tpu_torch/tools/recipes.py``),
on the CPU: the counterpart of ``tests/test_scripts.py`` for the JAX CLIs.

- Every script of ``scripts/`` that calls a CLI lists, under ``--print``,
  one command per call the shell makes (four for a loop over the RGQA
  testdev subsets), each ``<python> -m rgqa_tpu_torch.cli.<name>`` with
  the script's flags in its order, and each parses in the port's
  ``parse_cli``; the JAX package's own audit of the script names the same
  module and flags.
- Each ``test_all.sh`` lists its siblings' rewritten commands, in order.
- ``--nproc_per_node 2`` puts every command under ``torch.distributed.run``
  (listed only: nothing starts).
- A script naming another module of the JAX package, or a CLI the port
  lacks, is refused by name.
- One live pair on the CPU: ``scripts/butd/train/vanilla.sh`` for an
  epoch, then ``scripts/butd/test/msp.sh`` from its ``LAST.pth``,
  writing each RGQA testdev subset's ``_result.json``.
"""

from __future__ import annotations

import glob
import io
import json
import os
import shlex
import subprocess
import sys

import pytest

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.tools import recipes
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = sorted(glob.glob(os.path.join(REPO, "scripts", "*", "*", "*.sh")))
CALLERS = [p for p in SCRIPTS if os.path.basename(p) != "test_all.sh"]
TEST_ALL = [p for p in SCRIPTS if os.path.basename(p) == "test_all.sh"]
SUBSETS = ("ClipEasy", "ClipHard", "PTEasy", "PTHard")


def _ids(paths):
    return [os.path.relpath(p, REPO) for p in paths]


def _printed(path: str, *flags: str) -> list:
    out = io.StringIO()
    assert recipes.main([path, "--print", *flags], stdout=out) == 0
    return [shlex.split(line) for line in out.getvalue().splitlines()]


def test_the_matrix_is_76_scripts_of_72_calls():
    assert len(SCRIPTS) == 76 and len(TEST_ALL) == 4 and len(CALLERS) == 72
    calls = sum(open(p).read().count("python -m rgqa_tpu.cli.") for p in CALLERS)
    assert calls == 72


@pytest.mark.parametrize("path", CALLERS, ids=_ids(CALLERS))
def test_each_call_runs_through_the_port_cli(path):
    from test_scripts import _commands

    want = list(_commands(path))  # the JAX audit's (module, flags), shell variables as DUMMY
    assert len(want) == 1
    module, flags = want[0]
    got = _printed(path)
    loops = "for subset in" in open(path).read()
    assert len(got) == (len(SUBSETS) if loops else 1)
    for cmd in got:
        assert cmd[:3] == [sys.executable, "-m", module.replace("rgqa_tpu.", "rgqa_tpu_torch.", 1)]
        # The audit's flags in their order; the shell also expands the
        # variables that the audit leaves out ($EXTRA).
        rest = iter(a for a in cmd[3:] if a.startswith("--"))
        assert all(any(a == b for b in rest) for a in flags if a.startswith("--")), (cmd, flags)
        cfg, _ = port_config.parse_cli(cmd[3:])  # SystemExit on a flag the port does not take
        assert cfg is not None
    if loops:
        assert [cmd[cmd.index("--test") + 1] for cmd in got] == [f"GQAUQ_testdev_questions_{s}" for s in SUBSETS]


@pytest.mark.parametrize("path", TEST_ALL, ids=_ids(TEST_ALL))
def test_test_all_lists_its_siblings_commands(path):
    text = open(path).read()
    siblings = [line.split('"$HERE"/')[1].split()[0] for line in text.splitlines() if line.startswith("sh ")]
    assert len(siblings) >= 3
    want = [cmd for name in siblings for cmd in _printed(os.path.join(os.path.dirname(path), name), "--fp32")]
    assert _printed(path, "--fp32") == want
    assert all(cmd[-1] == "--fp32" for cmd in want)  # "$@" reaches every sibling


def test_nproc_per_node_runs_each_command_under_torchrun():
    got = _printed(os.path.join(REPO, "scripts", "lxmert", "test", "msp.sh"), "--nproc_per_node", "2",
                   "--device", "cpu")
    assert len(got) == 4
    for cmd in got:
        assert cmd[:8] == [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                           "-m", "rgqa_tpu_torch.cli.evaluate"]
        assert cmd[-2:] == ["--device", "cpu"]


@pytest.mark.parametrize("body, names", [
    ("python -m rgqa_tpu.cli.no_such_cli --x 1\n", "rgqa_tpu.cli.no_such_cli"),
    ("python -c 'import rgqa_tpu.runner'\n", "rgqa_tpu.runner"),
    ("python -m rgqa_tpu.cli.train --fp32\nsh other.sh\n", "runs a shell script other than a sibling"),
])
def test_a_script_the_port_cannot_run_is_refused_by_name(tmp_path, body, names):
    script = tmp_path / "recipe.sh"
    script.write_text("# a recipe\n" + body)
    with pytest.raises(SystemExit, match=names.replace(".", r"\.")):
        recipes.main([str(script), "--print"])


def test_the_butd_pair_runs_on_the_cpu(tmp_path):
    from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa

    data, out = str(tmp_path / "gqa"), str(tmp_path / "snap")
    make_synthetic_gqa(data, SyntheticSpec(n_images=16, n_train=48, n_valid=16, n_testdev=16))
    env = dict(os.environ, DATA_ROOT=data, OUTPUT=out, LOAD=os.path.join(out, "butd", "vanilla", "LAST"),
               OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    tiny = ["--device", "cpu", "--fp32", "--batchSize", "8", "--epochs", "1", "--lr", "1e-3"]
    for script in ("train/vanilla.sh", "test/msp.sh"):
        r = subprocess.run([sys.executable, "-m", "rgqa_tpu_torch.tools.recipes",
                            os.path.join(REPO, "scripts", "butd", *script.split("/")), *tiny],
                           capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
    assert os.path.isfile(os.path.join(out, "butd", "vanilla", "LAST.pth"))
    for subset in SUBSETS:
        with open(os.path.join(out, "butd", "msp", f"GQAUQ_testdev_questions_{subset}_result.json")) as f:
            assert "auaf" in json.load(f)
