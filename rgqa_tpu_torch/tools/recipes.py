"""The recipe scripts (``scripts/<backbone>/<train|test>/*.sh``) through the
port's CLIs.

    python -m rgqa_tpu_torch.tools.recipes scripts/lxmert/test/msp.sh [--print]
        [--nproc_per_node N] [flags...]

The scripts call the JAX package (``python -m rgqa_tpu.cli.<name>``),
which a machine without jax cannot import.  This reads a script, rewrites
each such call to ``<this python> -m rgqa_tpu_torch.cli.<name>`` and runs
the result under ``sh`` with the caller's environment (``DATA_ROOT``,
``OUTPUT``, ``LOAD``, ...) and ``flags`` as the script's ``"$@"``; the
script's loops, defaults and line continuations are the shell's, as
before.  A script that names any other module of the JAX package, or a
CLI the port lacks, is refused by name; a flag that the port's CLI
refuses keeps its refusal.  The ``test_all.sh`` scripts run their
siblings as ``sh "$HERE"/<x>.sh "$@"``: each sibling goes through the
same rewrite and runs in a subshell of its own.  ``scripts/`` is read,
never written.

- ``--print``: list the commands, one line each, without running them.
- ``--nproc_per_node N``: run each command on N ranks under
  ``python -m torch.distributed.run --standalone --nproc_per_node N``
  (one card a rank, or with ``--device cpu`` N processes over gloo),
  the counterpart of a JAX run over every device of a host.

It exits with the script's status, as ``sh script.sh`` would.  It
imports nothing of torch or JAX.
"""

from __future__ import annotations

import importlib.util
import os
import re
import shlex
import subprocess
import sys
from typing import Optional

__all__ = ["rewrite", "commands", "main"]

CALL = re.compile(r"\bpython\s+-m\s+rgqa_tpu\.cli\.(\w+)")
SIBLING = re.compile(r'\bsh\s+"\$HERE"/([\w.-]+\.sh)')
OTHER = re.compile(r"\brgqa_tpu\b(?:\.[\w.]+)?")  # not rgqa_tpu_torch
# --print: each command's words, separated by US, ended by RS.
RECORD = "__recipe() { printf '%s\\037' \"$@\"; printf '\\036\\n'; }\n"


def _launcher(nproc: Optional[int]) -> list:
    if nproc is None:
        return [sys.executable]
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc)]


def rewrite(path: str, *, nproc: Optional[int] = None, show: bool = False, _depth: int = 0) -> str:
    """The text of the script at ``path`` with every JAX CLI call made a
    call of the port's (``show``: a call of the shell function that
    prints it), and each sibling it runs inlined as a subshell function
    rewritten alike.  Raises ``SystemExit`` naming what it refuses."""
    with open(path) as f:
        text = f.read()
    launcher = " ".join(shlex.quote(w) for w in (["__recipe"] if show else []) + _launcher(nproc))

    def call(m: re.Match) -> str:
        module = f"rgqa_tpu_torch.cli.{m.group(1)}"
        if importlib.util.find_spec(module) is None:
            raise SystemExit(f"{path}: calls rgqa_tpu.cli.{m.group(1)}, which the port does not have ({module})")
        return f"{launcher} -m {module}"

    siblings = {}

    def sibling(m: re.Match) -> str:
        if _depth >= 2:
            raise SystemExit(f"{path}: runs {m.group(1)}: siblings nested too deep")
        fn = "__sibling_" + re.sub(r"\W", "_", m.group(1))
        if fn not in siblings:
            body = rewrite(os.path.join(os.path.dirname(path), m.group(1)), nproc=nproc, show=show,
                           _depth=_depth + 1)
            siblings[fn] = f"{fn}() (\n{body}\n)\n"
        return fn

    text = SIBLING.sub(sibling, CALL.sub(call, text))
    code = "\n".join(line for line in text.splitlines() if not line.lstrip().startswith("#"))
    left = OTHER.search(code)
    if left:
        raise SystemExit(f"{path}: names {left.group(0)} of the JAX package, which the port's recipes cannot run")
    if re.search(r"(^|[;&|(\s])sh\s", code):
        raise SystemExit(f'{path}: runs a shell script other than a sibling (sh "$HERE"/<x>.sh)')
    return (RECORD if show and _depth == 0 else "") + "".join(siblings.values()) + text


def _run(path: str, text: str, flags: list, capture: bool, env: Optional[dict] = None) -> subprocess.CompletedProcess:
    return subprocess.run(["sh", "-c", text, path, *flags], stdout=subprocess.PIPE if capture else None,
                          text=True, env=dict(os.environ if env is None else env))


def commands(path: str, flags: list = (), *, nproc: Optional[int] = None, env: Optional[dict] = None) -> list:
    """The commands that ``path`` runs with ``flags`` in the environment
    ``env`` (default this process's), each an argv list, in order (the
    shell expands them; nothing runs)."""
    proc = _run(path, rewrite(path, nproc=nproc, show=True), list(flags), capture=True, env=env)
    if proc.returncode:
        raise SystemExit(f"{path}: the shell exited {proc.returncode} listing its commands")
    return [record.split("\037")[:-1] for record in proc.stdout.split("\036\n") if "\037" in record]


USAGE = "usage: python -m rgqa_tpu_torch.tools.recipes SCRIPT.sh [--print] [--nproc_per_node N] [flags...]"


def _own(argv: list) -> tuple[str, bool, Optional[int], list]:
    """(the script, ``--print``, ``--nproc_per_node``, the script's flags)
    of ``argv``: the script first, this tool's two options anywhere after
    it, every other word the script's."""
    if not argv or argv[0].startswith("-"):
        raise SystemExit(USAGE)
    script, rest, show, nproc, flags = argv[0], iter(argv[1:]), False, None, []
    for word in rest:
        if word == "--print":
            show = True
        elif word == "--nproc_per_node" or word.startswith("--nproc_per_node="):
            value = word.split("=", 1)[1] if "=" in word else next(rest, "")
            if not value.isdigit() or int(value) < 1:
                raise SystemExit(f"--nproc_per_node {value!r}: a count of ranks, at least 1")
            nproc = int(value)
        else:
            flags.append(word)
    return script, show, nproc, flags


def main(argv=None, stdout=None) -> int:
    script, show, nproc, flags = _own(list(sys.argv[1:] if argv is None else argv))
    stdout = stdout or sys.stdout
    if show:
        for cmd in commands(script, flags, nproc=nproc):
            print(shlex.join(cmd), file=stdout)
        return 0
    stdout.flush()
    return _run(script, rewrite(script, nproc=nproc), flags, capture=False).returncode


if __name__ == "__main__":
    sys.exit(main())
