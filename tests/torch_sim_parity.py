"""What the simulator's parity tests share: one command line through the JAX
package's CLI and the port's, in this process, with the same flags.

The stdout lines must be equal and every named file under each side's
``--out`` byte-equal.  Imported by ``tests/test_torch_sim_cli.py``,
``tests/test_torch_topology.py`` and ``tests/test_torch_faults.py``.
"""

import json
from pathlib import Path

import pytest

from gpuschedule_tpu import cli as jax_cli
from gpuschedule_tpu_torch import cli

ROOT = Path(__file__).resolve().parents[1]
PHILLY_SAMPLE = str(ROOT / "data" / "philly_sample.csv")
OUTPUTS = ("jobs.csv", "utilization.csv", "counters.json", "metrics.prom", "metrics.json")


def run_both(capsys, tmp_path, argv, files=OUTPUTS, cmd="run"):
    """``cmd`` through the JAX CLI and the port's, each with ``--out`` a
    directory of its own (``{out}`` in ``argv`` names it too); returns the
    port's stdout line, parsed."""
    lines = []
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        out = tmp_path / side
        extra = [a.replace("{out}", str(out)) for a in argv]
        assert main([cmd, *extra, "--out", str(out)]) == 0
        lines.append(capsys.readouterr().out.strip().splitlines())
    assert lines[0] == lines[1] and len(lines[1]) == 1
    for name in files:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes(), name
    return json.loads(lines[1][0])


def counters(tmp_path) -> dict:
    """The port's ``counters.json`` of the last :func:`run_both`."""
    return json.loads((tmp_path / "port" / "counters.json").read_text())


def errors_alike(capsys, argv) -> str:
    """``run`` with flags that both CLIs refuse: the same ``SystemExit``
    message from each; returns it."""
    msgs = []
    for main in (jax_cli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(["run", *argv])
        msgs.append(str(e.value))
    capsys.readouterr()
    assert msgs[0] == msgs[1]
    return msgs[1]
