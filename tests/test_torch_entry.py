"""The port's driver entry points (``gpuschedule_tpu_torch/entry.py``) on
the CPU: ``dryrun_multichip(4)`` spawns four gloo ranks and runs the
reference's three steps (a dp 1 x sp 2 x tp 2 ring-flash step of
``transformer-tiny``, a ``moe-top2-tiny`` step with ep-over-tp, a
``PipelinedLM`` step at pp 2 x dp 2), each loss finite, and prints the
reference's summary line; ``entry()`` asks for the card and, with none,
raises rather than running on the CPU."""

import math
import re

import pytest
import torch

from gpuschedule_tpu_torch import entry as port_entry


def test_dryrun_multichip_on_four_gloo_ranks(capsys):
    line = port_entry.dryrun_multichip(4, device="cpu")
    m = re.fullmatch(r"dryrun_multichip ok: mesh\(dp=1, sp=2, tp=2\) loss=(\S+) "
                     r"moe_ep_loss=(\S+) pipeline_pp2=(\S+)", line)
    assert m is not None, line
    assert all(math.isfinite(float(x)) for x in m.groups())
    assert capsys.readouterr().out.strip().endswith(line)


def test_entry_runs_on_the_card_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs entry() on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
