"""Port parity for the ``run`` and ``gen-trace`` commands, and Optimus's
online profiling on the CPU.

Each ``run`` goes through both packages' CLIs (``main`` in this process)
with the same flags: the summary line must be equal and every file under
``--out`` (and ``--prom``) byte-equal.  ``gen-trace`` writes byte-equal
CSVs.  The flags whose modules the port has not yet are rejected by its
parser (``tests/test_torch_topology.py`` and ``tests/test_torch_faults.py``
run the flags of the topology and faults modules).  Optimus online on
the CPU (``device="cpu"``, transformer-tiny, a tiny batch) measures
through the port's ``profile_model`` and writes a curve file from which
both packages replay offline to equal summaries;
only a ``ValueError`` from the harness falls back to a curve, as in the
JAX package, and any other failure fails the replay.
"""

import json
from pathlib import Path

import pytest
from torch_sim_parity import OUTPUTS, PHILLY_SAMPLE, run_both

from gpuschedule_tpu import cli as jax_cli
from gpuschedule_tpu.policies.optimus import OptimusPolicy as JaxOptimus
from gpuschedule_tpu.profiler.goodput import CurveCache as JaxCurveCache
from gpuschedule_tpu_torch import cli
from gpuschedule_tpu_torch.cluster import TpuCluster
from gpuschedule_tpu_torch.policies import make_policy
from gpuschedule_tpu_torch.policies.optimus import DEFAULT_CURVE, OptimusPolicy
from gpuschedule_tpu_torch.profiler import CurveCache, harness
from gpuschedule_tpu_torch.sim import Simulator
from gpuschedule_tpu_torch.sim.trace import generate_poisson_trace, save_trace_csv


@pytest.fixture(scope="module")
def curves(tmp_path_factory):
    """A curve file as the port's ``profile`` writes it: one curve for each
    default model of the synthetic traces."""
    from gpuschedule_tpu_torch.profiler.goodput import GoodputCurve

    path = tmp_path_factory.mktemp("curves") / "curves.json"
    cache = CurveCache(path)
    for i, name in enumerate(("transformer-tiny", "transformer-small", "transformer-base",
                              "mlp-wide")):
        cache.put(name, GoodputCurve((0.5 + i, 0.01 * i, 1e-5), pod_chips=256,
                                     dcn_grad_bytes=1e8), source="test")
    cache.save()
    return str(path)


@pytest.mark.parametrize("policy", ["fifo", "srtf", "dlas", "optimus"])
def test_run_synthetic_on_simple(policy, curves, capsys, tmp_path):
    got = run_both(capsys, tmp_path, ["--policy", policy, "--cluster", "simple", "--chips", "64",
                                      "--synthetic", "200", "--seed", "42", "--curves", curves])
    assert got["num_finished"] == got["arrivals"] == 200.0


def test_run_philly_sample_with_observability(capsys, tmp_path):
    """Attribution, periodic and on-change samples, cache telemetry and a
    prefix on a v5e 8x8 pod under DLAS with its automatic restart cost."""
    got = run_both(capsys, tmp_path, [
        "--policy", "dlas", "--policy-arg", "restart_overhead=auto", "--cluster", "tpu-v5e",
        "--dims", "8x8", "--philly", PHILLY_SAMPLE, "--attrib", "--sample-interval", "600",
        "--sample-on-change", "--cache-stats", "--prefix", "x_"],
        files=[f"x_{name}" for name in OUTPUTS])
    assert "delay_capacity_s" in got and any(k.startswith("cache_") for k in got)


def test_run_gen_trace_on_multislice_v5p(curves, capsys, tmp_path):
    """A trace from each package's ``gen-trace`` (byte-equal), replayed on two
    v5p pods under Optimus from the curve file, cut at ``--max-time``, with
    ``--prom`` beside ``--out``."""
    paths = {}
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        paths[side] = tmp_path / f"{side}.csv"
        assert main(["gen-trace", "--num-jobs", "300", "--seed", "3", "--arrival-rate", "0.05",
                     "--out", str(paths[side])]) == 0
    assert capsys.readouterr().out.count("wrote 300 jobs") == 2
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    got = run_both(capsys, tmp_path, [
        "--policy", "optimus", "--curves", curves, "--cluster", "tpu-v5p", "--pods", "2",
        "--trace", str(paths["port"]), "--max-time", "4000", "--prom", "{out}.prom"])
    assert got["num_unfinished"] > 0
    assert Path(f"{tmp_path}/jax.prom").read_bytes() == Path(f"{tmp_path}/port.prom").read_bytes()


@pytest.mark.parametrize("argv", [
    ["--num-jobs", "120", "--seed", "5", "--failure-rate", "0.2", "--util-min", "0.3"],
    ["--num-jobs", "120", "--seed", "5", "--philly-like"],
])
def test_gen_trace_csvs_byte_equal(argv, capsys, tmp_path):
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        assert main(["gen-trace", *argv, "--out", str(tmp_path / f"{side}.csv")]) == 0
    outs = capsys.readouterr().out.splitlines()
    assert [o.replace("port.csv", "jax.csv") for o in outs[1:]] == outs[:1]
    assert (tmp_path / "jax.csv").read_bytes() == (tmp_path / "port.csv").read_bytes()


def test_spans_record_the_engine_loop(capsys, tmp_path):
    """``--spans``: the summary line is the plain run's, spans.trace.json
    holds the engine's batch and policy spans, and stderr the span summary."""
    assert cli.main(["run", "--synthetic", "50", "--spans", "--out", str(tmp_path)]) == 0
    out, err = capsys.readouterr()
    assert cli.main(["run", "--synthetic", "50"]) == 0
    assert capsys.readouterr().out == out
    names = {e["name"] for e in json.loads((tmp_path / "spans.trace.json").read_text())
             ["traceEvents"] if e["ph"] == "X"}
    assert names == {"sim.run", "sim.batch", "policy.schedule"}
    assert set(json.loads(err.strip().splitlines()[-1])["spans"]) == names
    from gpuschedule_tpu_torch.obs import get_tracer

    get_tracer().disable().reset()


@pytest.mark.parametrize("flag", [
    ["--events"], ["--perfetto", "t.json"], ["--flush-events", "60"], ["--history", "h.db"],
    ["--snapshot", "s.pkl", "--snapshot-every", "60"], ["--resume", "s.pkl"],
    ["--self-profile", "p.json"], ["--accounting", "v2"],
])
def test_flags_of_later_slices_are_rejected(flag, capsys, tmp_path, monkeypatch):
    """Each flag of the event-stream, snapshot and v2 slice runs in the
    port's parser as in the JAX CLI: the same stdout line and the same
    files (the self-profile's wall seconds aside, and ``--resume``
    finishing a snapshot of its own package)."""
    lines, files = [], []
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        if "--resume" in flag:
            assert main(["run", "--synthetic", "5", "--snapshot", "s.pkl",
                         "--snapshot-every", "2000"]) == 0
            capsys.readouterr()
        assert main(["run", "--synthetic", "5", *flag, "--out", "o"]) == 0
        lines.append(capsys.readouterr().out)
        files.append({f.name: f.read_bytes() for f in sorted((tmp_path / side).rglob("*"))
                      if f.is_file() and f.suffix not in (".db", ".pkl") and f.name != "p.json"})
    assert lines[0] == lines[1] and json.loads(lines[1])["num_finished"] == 5
    assert files[0] == files[1]
    if "--self-profile" in flag:
        docs = [json.loads((tmp_path / side / "p.json").read_text())["selfprof"]
                for side in ("jax", "port")]
        assert [set(d["phases"]) for d in docs] == [set(docs[0]["phases"])] * 2
        assert docs[0]["batches"] == docs[1]["batches"] > 0
    if "--history" in flag:
        rows = []
        for side, main in (("jax", jax_cli.main), ("port", cli.main)):
            assert main(["history", "list", "--store", str(tmp_path / side / "h.db")]) == 0
            rows.append(json.loads(capsys.readouterr().out))
        assert rows[0] == rows[1] and rows[1]["kind"] == "run"


def test_profile_charge_equals_jax(curves):
    ours, ref = CurveCache(curves), JaxCurveCache(curves)
    for kw in ({}, {"profile_ks": (1, 2, 4, 8), "profile_iters": 20},
               {"profile_warmup": 0, "profile_compile_s": 0.0}, {"profile_time_cost": 42.0}):
        for name in ours.models():
            for ks in (None, (2, 4, 8)):
                assert OptimusPolicy(**kw)._profile_charge(ours.get(name), ks=ks) \
                    == JaxOptimus(**kw)._profile_charge(ref.get(name), ks=ks)


@pytest.fixture
def tiny_trace(tmp_path):
    path = tmp_path / "tiny.csv"
    save_trace_csv(generate_poisson_trace(60, seed=1, models=("transformer-tiny",)), path)
    return str(path)


def test_optimus_online_on_the_cpu(tiny_trace, capsys, tmp_path, monkeypatch):
    """``run --online --device cpu`` profiles transformer-tiny once through the
    port's ``profile_model`` on the CPU, charges the profiling run, and
    writes a curve file; both packages replay offline from it to the same
    summary and files."""
    calls = []
    real = harness.profile_model

    def counted(model, **kw):
        calls.append((model, str(kw["device"]), kw["batch_size"], kw["seq_len"]))
        return real(model, **kw)

    monkeypatch.setattr(harness, "profile_model", counted)
    curves = str(tmp_path / "online.json")
    world = ["--policy", "optimus", "--cluster", "tpu-v5e", "--dims", "8x8", "--trace", tiny_trace,
             "--curves", curves, "--policy-arg", "profile_batch=2", "--policy-arg",
             "profile_seq=16"]
    assert cli.main(["run", *world, "--online", "--device", "cpu"]) == 0
    online = json.loads(capsys.readouterr().out)
    assert calls == [("transformer-tiny", "cpu", 2, 16)]
    assert online["profiling_runs"] == 1.0 and online["num_finished"] == 60.0
    entry = json.loads(Path(curves).read_text())
    assert list(entry) == ["transformer-tiny"] and entry["transformer-tiny"]["points"]["1"] > 0
    offline = run_both(capsys, tmp_path, world)
    assert "profiling_runs" not in offline  # a warm cache pays no profiling charge


def test_only_a_value_error_falls_back(tiny_trace, monkeypatch):
    """An unmeasurable layout (``ValueError``) falls back to the default
    curve with no charge, as in the JAX package; anything else, a CUDA or a
    build failure, propagates out of the replay."""
    def jobs():
        return generate_poisson_trace(20, seed=1, models=("transformer-tiny",))

    def unmeasurable(model, **kw):
        raise ValueError("sp*tp*pp=8 exceeds the 1 available devices; nothing is measurable")

    monkeypatch.setattr(harness, "profile_model", unmeasurable)
    pol = OptimusPolicy(online=True, device="cpu")
    res = Simulator(TpuCluster("v5e", dims=(8, 8)), pol, jobs()).run().summary()
    assert pol._curves == {"transformer-tiny": DEFAULT_CURVE} and "profiling_runs" not in res
    assert res == Simulator(TpuCluster("v5e", dims=(8, 8)), make_policy("optimus"),
                            jobs()).run().summary()
    for exc in (RuntimeError("CUDA error: an illegal memory access was encountered"),
                OSError("nvcc failed")):
        def failing(model, **kw):
            raise exc

        monkeypatch.setattr(harness, "profile_model", failing)
        with pytest.raises(type(exc), match=str(exc)):
            Simulator(TpuCluster("v5e", dims=(8, 8)), OptimusPolicy(online=True, device="cpu"),
                      jobs()).run()
