"""The port's ``train`` summary line against the JAX CLI's, on the CPU:
the same arguments give the same keys, ``mesh`` as the JAX CLI fills it at
one device, and ``tokens_per_s`` rounded to one decimal as the JAX CLI
rounds it; the port's one extra key is ``device``."""

import json

import pytest

jax = pytest.importorskip("jax")

from gpuschedule_tpu.cli import main as jax_main  # noqa: E402
from gpuschedule_tpu.parallel.mesh import AXES as JAX_AXES  # noqa: E402
from gpuschedule_tpu_torch.cli import main  # noqa: E402
from gpuschedule_tpu_torch.parallel.mesh import AXES as MESH_AXES  # noqa: E402

ARGS = ["train", "--model", "transformer-tiny", "--steps", "3", "--batch-size", "2",
        "--seq-len", "32"]


def _line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_summary_matches_the_jax_cli(capsys):
    assert jax_main(ARGS + ["--devices", "1"]) == 0
    ref = _line(capsys)
    assert main(ARGS + ["--device", "cpu"]) == 0
    ours = _line(capsys)

    assert set(ours) == set(ref) | {"device"}
    assert MESH_AXES == JAX_AXES
    assert ours["mesh"] == ref["mesh"] == {"pp": 1, "dp": 1, "sp": 1, "tp": 1}
    assert ours["checkpoint"] is None is ref["checkpoint"]
    assert ours["resumed_at_step"] is None is ref["resumed_at_step"]
    assert ours["model"] == ref["model"] and ours["steps"] == ref["steps"] == 3
    for line in (ours, ref):
        assert line["tokens_per_s"] > 0 and round(line["tokens_per_s"], 1) == line["tokens_per_s"]
    assert ours["device"] == "cpu"
