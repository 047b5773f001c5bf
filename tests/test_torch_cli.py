"""The port's ``train`` CLI against the JAX CLI's, on the CPU.

- The summary line: the same arguments give the same keys, ``mesh`` as the
  JAX CLI fills it at one device, and ``tokens_per_s`` rounded to one
  decimal as the JAX CLI rounds it; the port's one extra key is
  ``device``.
- Data and checkpoints: ``--data``/``--ckpt`` then ``--restore`` resume
  where a straight run goes (exact on the CPU), the datastream sidecar
  equals the JAX CLI's for the same flags, the drift warning and the
  ``--host-shard`` errors are the JAX CLI's word for word.
- The tracer: the same calls record spans of the same names with the same
  attribute keys in both packages, and ``train`` prints the
  ``{"spans": ...}`` line on stderr when tracing is on.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from gpuschedule_tpu import cli as jax_cli  # noqa: E402
from gpuschedule_tpu.cli import main as jax_main  # noqa: E402
from gpuschedule_tpu.obs import get_tracer as jax_tracer  # noqa: E402
from gpuschedule_tpu.parallel.mesh import AXES as JAX_AXES  # noqa: E402
from gpuschedule_tpu.profiler import harness as jax_harness  # noqa: E402
from gpuschedule_tpu_torch.cli import build_parser, main  # noqa: E402
from gpuschedule_tpu_torch.data import TokenFileDataset  # noqa: E402
from gpuschedule_tpu_torch.obs import get_tracer  # noqa: E402
from gpuschedule_tpu_torch.parallel.mesh import AXES as MESH_AXES  # noqa: E402
from gpuschedule_tpu_torch.profiler import harness  # noqa: E402

ARGS = ["train", "--model", "transformer-tiny", "--steps", "3", "--batch-size", "2",
        "--seq-len", "32"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the tiny CPU steps here: the driver runs six
    test workers on the box's cores, where more threads a step only wait
    on each other.  Restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


DATA_ARGS = ["train", "--model", "transformer-tiny", "--batch-size", "2", "--seq-len", "32",
             "--device", "cpu"]


@pytest.fixture
def corpus(tmp_path):
    """Four batches of (2, 32) tokens: a 6-step run crosses an epoch."""
    tokens = np.random.default_rng(0).integers(0, 8192, size=4 * 64)
    return str(TokenFileDataset.write(tokens, tmp_path / "tok.bin"))


def _namespace(argv):
    """``argv`` parsed (the JAX CLI builds its parser inside ``main``; the
    port's flags have its names, which are all its sidecar functions read)."""
    return build_parser().parse_args(argv)


def test_train_data_ckpt_then_restore(tmp_path, corpus, capsys):
    """3 steps from the file with --ckpt, then 3 more with --restore: the
    summary names the checkpoint and the resume step, the resumed run ends
    where a straight 6-step run ends (exact: the same floats; the stream
    crosses from epoch 0 to 1 at the resume point's arithmetic), and the
    sidecar equals the JAX CLI's for the same flags."""
    ck = str(tmp_path / "ck")
    data = DATA_ARGS + ["--data", corpus]
    assert main(data + ["--steps", "3", "--ckpt", ck]) == 0
    saved = _line(capsys)
    assert saved["checkpoint"] == ck and saved["resumed_at_step"] is None
    assert main(data + ["--steps", "3", "--restore", ck]) == 0
    resumed = _line(capsys)
    assert resumed["checkpoint"] is None and resumed["resumed_at_step"] == 3
    assert main(data + ["--steps", "6"]) == 0
    straight = _line(capsys)
    assert resumed["last_loss"] == straight["last_loss"]

    ours = json.loads(Path(ck + ".datastream.json").read_text())
    jax_args = _namespace(data + ["--steps", "3", "--ckpt", str(tmp_path / "jax_ck")])
    jax_cli._write_datastream_meta(jax_args)
    ref = json.loads(Path(str(tmp_path / "jax_ck") + ".datastream.json").read_text())
    assert set(ours) == set(ref) == {"seed", "batch_size", "seq_len", "host_shard", "data"}
    assert ours == ref


@pytest.mark.parametrize("drift", [["--seed", "1"], ["--seq-len", "16"], ["--data", None]],
                         ids=["seed", "seq-len", "other-file"])
def test_restore_drift_warning_matches_the_jax_cli(tmp_path, corpus, capsys, drift):
    ck = str(tmp_path / "ck")
    assert main(DATA_ARGS + ["--data", corpus, "--steps", "1", "--ckpt", ck]) == 0
    capsys.readouterr()
    if drift[1] is None:
        other = np.random.default_rng(1).integers(0, 8192, size=4 * 64)
        drift = ["--data", str(TokenFileDataset.write(other, tmp_path / "other.bin"))]
    argv = DATA_ARGS + ["--data", corpus, "--steps", "1", "--restore", ck] + drift
    assert main(argv) == 0
    ours = [x for x in capsys.readouterr().err.splitlines() if x.startswith("WARNING")]
    jax_cli._warn_on_datastream_drift(_namespace(argv))
    ref = [x for x in capsys.readouterr().err.splitlines() if x.startswith("WARNING")]
    assert len(ours) == 1 and ours == ref


@pytest.mark.parametrize("shard", ["x", "2,2", "0,0", "0,3"],
                         ids=["not-a-pair", "index-past-count", "count-zero", "uneven-epochs"])
def test_host_shard_messages_match_the_jax_cli(corpus, shard):
    argv = DATA_ARGS[:-2] + ["--data", corpus, "--steps", "1", "--host-shard", shard]
    with pytest.raises(SystemExit) as ours:
        main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as ref:
        jax_main(argv + ["--devices", "1"])
    assert str(ours.value) == str(ref.value) and "--host-shard" in str(ours.value)


def test_host_shard_resumes_at_the_global_position(tmp_path, corpus, capsys):
    """Under --host-shard 1,2 a host that made one update resumes at global
    position 2 (its second batch, position 3): the resumed run's loss is
    the straight 2-step run's second."""
    ck = str(tmp_path / "ck")
    data = DATA_ARGS + ["--data", corpus, "--host-shard", "1,2"]
    assert main(data + ["--steps", "1", "--ckpt", ck]) == 0
    assert main(data + ["--steps", "1", "--restore", ck]) == 0
    assert main(data + ["--steps", "2"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines[1]["resumed_at_step"] == 1
    assert lines[1]["last_loss"] == lines[2]["last_loss"]


@pytest.fixture
def tracers():
    """Both packages' tracers on, emptied, and off again after."""
    pair = (get_tracer(), jax_tracer())
    for t in pair:
        t.reset().enable()
    yield pair
    for t in pair:
        t.disable().reset()


def _shapes(tracer) -> dict:
    """{span name: sorted attribute keys} (one set per name)."""
    out: dict = {}
    for sp in tracer.spans:
        out.setdefault(sp.name, set()).add(tuple(sorted(sp.attrs)))
    return out


def test_spans_match_the_jax_package(tracers, tmp_path):
    """The same calls record spans of the same names with the same
    attribute keys: the train step, the harness's timed blocks, the
    measured step, the profile and the trace capture."""
    ours, ref = tracers
    kw = dict(batch_size=2, seq_len=16)
    harness.profile_model("transformer-tiny", ks=(1,), device="cpu", **kw)
    harness.capture_trace("transformer-tiny", tmp_path / "ours", steps=1, device="cpu", **kw)
    jax_harness.profile_model("transformer-tiny", ks=(1,), devices=jax.devices()[:1], **kw)
    jax_harness.capture_trace("transformer-tiny", tmp_path / "ref", steps=1,
                              devices=jax.devices()[:1], **kw)
    got, want = _shapes(ours), _shapes(ref)
    assert set(want) == {"train.step", "profiler.block", "profiler.measure_step_time",
                         "profiler.profile_model", "profiler.capture_trace"}
    assert got == want
    # one of each harness span; the train steps differ by design: the
    # port's trace capture warms up twice (build, then capture the graph)
    # where the JAX one compiles once
    counts = [{name: a["count"] for name, a in t.summary().items() if name != "train.step"}
              for t in (ours, ref)]
    assert counts[0] == counts[1] == {name: 1 for name in want if name != "train.step"}


def test_train_prints_the_spans_line(tracers, capsys):
    """With the tracer on, ``train`` prints the summary on stdout and the
    spans on stderr, a ``train.step`` a step, as the JAX CLI does."""
    assert main(ARGS + ["--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert len(out.out.strip().splitlines()) == 1
    spans = json.loads(out.err.strip().splitlines()[-1])["spans"]
    assert spans["train.step"]["count"] == 3
    assert set(spans["train.step"]) == {"count", "total_s", "max_s", "mean_s"}


def test_tracing_off_records_nothing(capsys):
    assert not get_tracer().enabled
    assert main(ARGS + ["--device", "cpu"]) == 0
    assert get_tracer().spans == [] and "spans" not in capsys.readouterr().err
