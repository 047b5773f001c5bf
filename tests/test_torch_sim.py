"""Port parity for the simulator: the port's replay against the JAX
package's, at tolerance zero.

The same trace, cluster, policy, seed and curve file go through both
packages' ``Simulator``; the summaries must be equal and the written files
(``jobs.csv``, ``utilization.csv``, ``counters.json``, ``metrics.prom``,
``metrics.json``) byte-equal.  The matrix is FIFO, SRTF, Tiresias-DLAS and
Optimus from a curve file, on ``SimpleCluster(64)``, a v5e 8x8 pod and two
v5p pods (multislice), over a 200-job synthetic trace, the 300-job Philly
sample and a trace that each package's ``gen-trace`` wrote.  Then the
engine's other loops (traced, profiled, paused), its event stream, the
what-if mutations it keeps, its refusals, and the copied tables.
"""

import dataclasses
import inspect
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from gpuschedule_tpu import cli as jax_cli
from gpuschedule_tpu.cluster import SimpleCluster as JaxSimple, TpuCluster as JaxTpu
from gpuschedule_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from gpuschedule_tpu.obs.selfprof import PhaseProfiler
from gpuschedule_tpu.policies import make_policy as jax_make_policy
from gpuschedule_tpu.policies import optimus as jax_optimus
from gpuschedule_tpu.profiler.goodput import CurveCache as JaxCurveCache
from gpuschedule_tpu.sim import Simulator as JaxSimulator
from gpuschedule_tpu.sim import job as jax_job, metrics as jax_metrics, overhead as jax_overhead
from gpuschedule_tpu.sim import philly as jax_philly, trace as jax_trace
from gpuschedule_tpu.sim.job import Job as JaxJob
from gpuschedule_tpu_torch import cli
from gpuschedule_tpu_torch.cluster import SimpleCluster, TpuCluster
from gpuschedule_tpu_torch.models import MODEL_CONFIGS
from gpuschedule_tpu_torch.obs import MetricsRegistry, get_tracer
from gpuschedule_tpu_torch.policies import make_policy
from gpuschedule_tpu_torch.policies import optimus
from gpuschedule_tpu_torch.profiler.goodput import CurveCache, GoodputCurve
from gpuschedule_tpu_torch.sim import Simulator
from gpuschedule_tpu_torch.sim import job, metrics, overhead, philly, trace
from gpuschedule_tpu_torch.sim.job import Job

ROOT = Path(__file__).resolve().parents[1]
PHILLY_SAMPLE = ROOT / "data" / "philly_sample.csv"
OUTPUTS = ("jobs.csv", "utilization.csv", "counters.json", "metrics.prom", "metrics.json")

JAX = SimpleNamespace(
    Simulator=JaxSimulator, make_policy=jax_make_policy, CurveCache=JaxCurveCache,
    MetricsLog=jax_metrics.MetricsLog, MetricsRegistry=JaxRegistry, trace=jax_trace,
    philly=jax_philly, clusters={"simple": lambda: JaxSimple(64),
                                 "v5e-8x8": lambda: JaxTpu("v5e", dims=(8, 8)),
                                 "v5p-2pods": lambda: JaxTpu("v5p", num_pods=2)},
    main=jax_cli.main,
)
PORT = SimpleNamespace(
    Simulator=Simulator, make_policy=make_policy, CurveCache=CurveCache,
    MetricsLog=metrics.MetricsLog, MetricsRegistry=MetricsRegistry, trace=trace,
    philly=philly, clusters={"simple": lambda: SimpleCluster(64),
                             "v5e-8x8": lambda: TpuCluster("v5e", dims=(8, 8)),
                             "v5p-2pods": lambda: TpuCluster("v5p", num_pods=2)},
    main=cli.main,
)
GEN_TRACE = ["gen-trace", "--num-jobs", "150", "--seed", "7", "--failure-rate", "0.1",
             "--util-min", "0.5"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A curve file (distinct curves for every model the traces name; two
    multislice-aware, so Optimus grows past a v5p pod) and each package's
    ``gen-trace`` file."""
    tmp = tmp_path_factory.mktemp("world")
    cache = CurveCache(tmp / "curves.json")
    thetas = {"transformer-tiny": (0.3, 0.01, 1e-5), "transformer-small": (0.8, 0.02, 2e-5),
              "transformer-base": (2.0, 0.05, 4e-5), "mlp-wide": (0.5, 0.0, 1e-4)}
    for name, theta in thetas.items():
        dcn = 4.0 * MODEL_CONFIGS[name].param_count if name in ("transformer-small",
                                                                  "transformer-base") else None
        cache.put(name, GoodputCurve(theta, pod_chips=256, dcn_grad_bytes=dcn), source="test",
                  points={1: theta[0]})
    cache.save()
    traces = {}
    for side, pkg in (("jax", JAX), ("port", PORT)):
        traces[side] = tmp / f"{side}_trace.csv"
        assert pkg.main(GEN_TRACE + ["--out", str(traces[side])]) == 0
    return SimpleNamespace(curves=tmp / "curves.json", traces=traces)


def _jobs(pkg, kind, world, side):
    if kind == "synthetic":
        return pkg.trace.generate_poisson_trace(200, seed=42)
    if kind == "philly-sample":
        return pkg.philly.load_philly_csv(PHILLY_SAMPLE)
    return pkg.trace.load_trace_csv(world.traces[side])


def _policy(pkg, name, world):
    if name == "optimus":
        return pkg.make_policy("optimus", curve_cache=pkg.CurveCache(world.curves))
    return pkg.make_policy(name)


def replay(pkg, side, policy, cluster, kind, world, out, **sim_kw):
    """One replay the way ``run --out`` makes it: the summary, and the files."""
    registry = pkg.MetricsRegistry()
    log = pkg.MetricsLog(registry=registry)
    sim = pkg.Simulator(pkg.clusters[cluster](), _policy(pkg, policy, world),
                        _jobs(pkg, kind, world, side), metrics=log, **sim_kw)
    with log:
        res = sim.run()
    log.write(out)
    registry.write(prom_path=out / "metrics.prom", json_path=out / "metrics.json")
    return res.summary()


def assert_same_outputs(a: Path, b: Path) -> None:
    for name in OUTPUTS:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_gen_trace_files_are_byte_equal(world):
    assert world.traces["jax"].read_bytes() == world.traces["port"].read_bytes()


@pytest.mark.parametrize("kind", ["synthetic", "philly-sample", "gen-trace"])
@pytest.mark.parametrize("cluster", ["simple", "v5e-8x8", "v5p-2pods"])
@pytest.mark.parametrize("policy", ["fifo", "srtf", "dlas", "optimus"])
def test_replay_equals_jax(policy, cluster, kind, world, tmp_path):
    ref = replay(JAX, "jax", policy, cluster, kind, world, tmp_path / "jax")
    got = replay(PORT, "port", policy, cluster, kind, world, tmp_path / "port")
    assert got == ref
    assert got["num_finished"] == got["arrivals"]
    assert_same_outputs(tmp_path / "jax", tmp_path / "port")


@pytest.mark.parametrize("policy", ["fifo", "srtf", "dlas", "optimus"])
def test_multislice_gangs_equal_jax(policy, world):
    """Gangs larger than a pod: four 16-chip v5p pods (2x2x4), where the
    trace's 32- and 64-chip gangs span pods over DCN (``dcn/`` tracks), their
    progress priced by the port's own ICI/DCN model.  Summary and event
    stream equal the JAX package's."""
    out = []
    for pkg, side, cls in ((JAX, "jax", JaxTpu), (PORT, "port", TpuCluster)):
        log = pkg.MetricsLog(record_events=True)
        sim = pkg.Simulator(cls("v5p", dims=(2, 2, 4), num_pods=4), _policy(pkg, policy, world),
                            _jobs(pkg, "synthetic", world, side), metrics=log)
        out.append((sim.run().summary(), json.dumps(log.events, sort_keys=True)))
    assert out[0] == out[1]
    assert '"track": "dcn/' in out[1][1]


def test_events_and_attribution_equal_jax(world):
    """The event stream, rationale and blame legs included, is the JAX
    package's record for record, with periodic samples and cache telemetry."""
    streams = []
    for pkg, side in ((JAX, "jax"), (PORT, "port")):
        log = pkg.MetricsLog(record_events=True, attribution=True, cache_telemetry=True)
        sim = pkg.Simulator(pkg.clusters["v5e-8x8"](), pkg.make_policy("dlas"),
                            _jobs(pkg, "philly-sample", world, side), metrics=log,
                            sample_interval=600.0, sample_on_change=True)
        summary = sim.run().summary()
        streams.append((summary, json.dumps(log.events, sort_keys=True)))
    assert streams[0] == streams[1]
    assert any(k.startswith("delay_") for k in streams[1][0])


@pytest.mark.parametrize("policy", ["srtf", "optimus"])
def test_traced_and_profiled_loops_equal_plain(policy, world, tmp_path):
    """The traced loop (spans on) and the profiled loop (a phase profiler
    attached; the JAX package's, duck-typed) replay as the plain loop does,
    and the traced one records the JAX engine's spans."""
    plain = replay(JAX, "jax", policy, "v5e-8x8", "synthetic", world, tmp_path / "jax")
    tracer = get_tracer()
    was = tracer.enabled
    tracer.enable().reset()
    try:
        traced = replay(PORT, "port", policy, "v5e-8x8", "synthetic", world, tmp_path / "traced")
        spans = tracer.spans
    finally:
        tracer.enabled = was
        tracer.reset()
    assert traced == plain
    assert_same_outputs(tmp_path / "jax", tmp_path / "traced")
    names = {sp.name for sp in spans}
    assert names == {"sim.run", "sim.batch", "policy.schedule"}
    run_sp = next(sp for sp in spans if sp.name == "sim.run")
    assert run_sp.sim_start == 0.0 and run_sp.sim_end > 0.0
    assert all(sp.sim_start is not None for sp in spans)
    assert set(run_sp.attrs) == {"policy", "jobs", "batches"}
    prof = PhaseProfiler()
    profiled = replay(PORT, "port", policy, "v5e-8x8", "synthetic", world, tmp_path / "prof",
                      profiler=prof)
    assert profiled == plain and prof.batches > 0
    assert_same_outputs(tmp_path / "jax", tmp_path / "prof")


def test_run_until_then_run_and_what_if_mutations_equal_jax(world):
    """``run_until`` then ``run`` is the uninterrupted replay; an injected
    arrival and a policy swap at the pause give the JAX package's result."""
    out = []
    for pkg, side in ((JAX, "jax"), (PORT, "port")):
        whole = pkg.Simulator(pkg.clusters["v5e-8x8"](), pkg.make_policy("fifo"),
                              _jobs(pkg, "synthetic", world, side)).run().summary()
        sim = pkg.Simulator(pkg.clusters["v5e-8x8"](), pkg.make_policy("fifo"),
                            _jobs(pkg, "synthetic", world, side))
        sim.run_until(5000.0)
        assert sim.now <= 5000.0 and sim.finished
        resumed = sim.run().summary()
        assert resumed == whole
        sim = pkg.Simulator(pkg.clusters["v5e-8x8"](), pkg.make_policy("fifo"),
                            _jobs(pkg, "synthetic", world, side))
        sim.run_until(5000.0)
        job_cls = JaxJob if pkg is JAX else Job
        sim.inject_admit(job_cls("extra", 0.0, 16, 1800.0, model_name="transformer-base"))
        sim.swap_policy(pkg.make_policy("srtf"))
        out.append(sim.run().summary())
    assert out[0] == out[1] and out[1]["arrivals"] == 201


@pytest.mark.parametrize("kw,module", [
    ({"accounting": "v2"}, "sim/ledger.py"),
    ({"snapshot_every": 60.0, "snapshot_path": "snap.pkl"}, "sim/snapshot.py"),
])
def test_unported_engine_branches_refuse_at_construction(kw, module, tmp_path):
    """The engine arguments that ``module`` serves construct and replay
    as the JAX package's do: v2 accounting, periodic snapshots."""
    if "snapshot_path" in kw:
        kw = {**kw, "snapshot_path": tmp_path / kw["snapshot_path"]}
    got = []
    for pkg in (JAX, PORT):
        sim = pkg.Simulator(pkg.clusters["simple"](), pkg.make_policy("dlas"),
                            pkg.trace.generate_poisson_trace(60, seed=4), **kw)
        got.append(sim.run().summary())
        if "snapshot_path" in kw:
            assert sim._snap_writes > 0 and kw["snapshot_path"].exists()
    assert got[0] == got[1]


def test_unported_engine_calls_refuse(tmp_path):
    """``snapshot``, ``restore`` and ``fork`` finish a paused replay as the
    JAX package's do; the engine validates what the JAX engine validates,
    in its words."""
    got = []
    for pkg, side in ((JAX, "jax"), (PORT, "port")):
        sim = pkg.Simulator(pkg.clusters["simple"](), pkg.make_policy("dlas"),
                            pkg.trace.generate_poisson_trace(60, seed=4))
        sim.run_until(2000.0)
        sim.snapshot(tmp_path / side)
        forked = sim.fork().run().summary()
        restored = pkg.Simulator.restore(tmp_path / side).run().summary()
        assert forked == restored == sim.run().summary()
        got.append(restored)
    assert got[0] == got[1]
    for kw in ({"accounting": "v3"}, {"snapshot_path": "s"}, {"snapshot_every": 5.0},
               {"snapshot_every": -1.0, "snapshot_path": "s"}):
        msgs = []
        for pkg in (JAX, PORT):
            with pytest.raises(ValueError) as e:
                pkg.Simulator(pkg.clusters["simple"](), pkg.make_policy("fifo"), [], **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("name", ["no-such-policy"])
def test_policies_of_later_slices_are_unknown(name):
    with pytest.raises(ValueError, match=f"unknown policy {name!r}; known: "
                                         r"\['dlas', 'fifo', 'gandiva', 'optimus', 'srtf', "
                                         r"'themis'\]"):
        make_policy(name)


def test_copied_tables_equal_the_originals():
    assert trace.DEFAULT_MODELS == jax_trace.DEFAULT_MODELS
    assert trace.DEFAULT_SIZE_WEIGHTS == jax_trace.DEFAULT_SIZE_WEIGHTS
    assert trace.TRACE_FIELDS == jax_trace.TRACE_FIELDS
    assert philly.PHILLY_FIELDS == jax_philly.PHILLY_FIELDS
    assert philly.PHILLY_MEAN_INTERARRIVAL_S == jax_philly.PHILLY_MEAN_INTERARRIVAL_S
    assert metrics.JOB_CSV_FIELDS == jax_metrics.JOB_CSV_FIELDS
    assert [s.value for s in job.JobState] == [s.value for s in jax_job.JobState]
    assert {s.value for s in job.END_STATES} == {s.value for s in jax_job.END_STATES}
    assert [f.name for f in dataclasses.fields(Job)] == [f.name for f in dataclasses.fields(JaxJob)]
    assert optimus.DEFAULT_CURVE.theta == jax_optimus.DEFAULT_CURVE.theta
    for name in ("fifo", "srtf", "dlas", "optimus"):
        ours = inspect.signature(type(make_policy(name)).__init__).parameters
        ref = inspect.signature(type(jax_make_policy(name)).__init__).parameters
        defaults = {k: p.default for k, p in ours.items() if k != "device"}
        assert defaults == {k: p.default for k, p in ref.items()}, name
        assert type(make_policy(name)).rule_codes == type(jax_make_policy(name)).rule_codes
    assert "device" in inspect.signature(optimus.OptimusPolicy.__init__).parameters


@pytest.mark.parametrize("gen", ["v5e", "v5p"])
def test_resolve_overhead_over_the_zoo(gen):
    cluster, ref_cluster = TpuCluster(gen), JaxTpu(gen)
    for name in sorted(MODEL_CONFIGS) + ["not-in-the-zoo"]:
        for chips in (1, 4, 32, 256):
            ours = Job("j", 0.0, chips, 100.0, model_name=name)
            ref = JaxJob("j", 0.0, chips, 100.0, model_name=name)
            for spec in ("auto", 12.5):
                for migration in (False, True):
                    assert overhead.resolve_overhead(spec, ours, cluster, migration=migration) \
                        == jax_overhead.resolve_overhead(spec, ref, ref_cluster,
                                                         migration=migration)
            assert overhead.ckpt_write_seconds(name, chips, generation=gen) \
                == jax_overhead.ckpt_write_seconds(name, chips, generation=gen)
