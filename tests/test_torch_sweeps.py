"""Port parity for the sweeps (``faults/sweep.py``, ``net/sweep.py``), the
``faults`` subcommand, the worker pool (``sim/pool.py``), the fleet layer
(``obs/fleet.py``) and the tools built on them (``tools.fault_sweep``,
``net_sweep``, ``fault_chaos``, ``engine_bench``), at tolerance zero.

Every cell, artifact, line and stream must be the JAX package's bytes.
Anything pooled runs in a process of its own with a timeout (a pytest
process that has run JAX and torch must not fork): the port's tools
through ``python -m``, the pool's contract through
``tests/torch_pool_worker.py``; a pooled artifact is held to the JAX
package's serial one, and a pooled fleet trace to the JAX package's by
structure (``chip_smoke.fleet_shape``: its times are each process's own).
"""

import importlib.util
import json
import math
import os
import queue
import subprocess
import sys
import types

import pytest
from torch_sim_parity import ROOT

import chip_smoke
from gpuschedule_tpu import cli as jax_cli
from gpuschedule_tpu.faults import sweep as jax_fsweep
from gpuschedule_tpu.net import sweep as jax_nsweep
from gpuschedule_tpu.sim import pool as jax_pool
from gpuschedule_tpu_torch import cli
from gpuschedule_tpu_torch.faults import sweep as fsweep
from gpuschedule_tpu_torch.net import sweep as nsweep
from gpuschedule_tpu_torch.sim import pool
from gpuschedule_tpu_torch.tools import engine_bench, fault_chaos, fault_sweep, net_sweep

TIMEOUT_S = 120
ENV = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}
SMALL = {"num_jobs": 40, "dims": (4, 4), "seed": 3}


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_fault_sweep = _jax_tool("fault_sweep")
jax_net_sweep = _jax_tool("net_sweep")
jax_fault_chaos = _jax_tool("fault_chaos")
jax_engine_bench = _jax_tool("engine_bench")


def _text(doc) -> str:
    return json.dumps(fsweep.jsonable(doc), indent=2, sort_keys=True)


def test_policy_suite_grids_and_jsonable_are_the_jax_packages():
    assert fsweep.POLICY_CONFIGS == jax_fsweep.POLICY_CONFIGS
    assert fsweep.DEFAULT_MTBFS == jax_fsweep.DEFAULT_MTBFS
    assert nsweep.DEFAULT_SHARES == jax_nsweep.DEFAULT_SHARES
    sample = {"a": [math.inf, -math.inf, (1.5, math.nan)], "b": {"c": math.inf, "d": "x"}, "e": 2}
    assert fsweep.jsonable(sample) == jax_fsweep.jsonable(sample)
    assert json.dumps(fsweep.jsonable(sample)) == (
        '{"a": ["inf", "-inf", [1.5, "nan"]], "b": {"c": "inf", "d": "x"}, "e": 2}')


@pytest.mark.parametrize("policy", sorted(fsweep.POLICY_CONFIGS))
def test_fault_cell_is_the_jax_packages(policy):
    """One MTBF cell a policy, Gandiva included (40 jobs on a 4x4 pod:
    well under a second a side)."""
    got = fsweep.run_cell(policy, mtbf=21600.0, **SMALL)
    want = jax_fsweep.run_cell(policy, mtbf=21600.0, **SMALL)
    assert got["faults"] > 0 and _text(got) == _text(want)


def test_fault_cell_with_every_knob_and_its_stream(tmp_path):
    """Domains, weights, the hazard, stragglers, spot with a warning,
    priced writes, attribution and sampling, the stream captured: the cell
    and the stream are the JAX package's."""
    knobs = dict(mtbf=43200.0, restore=60.0, ckpt_write="auto", attribution=True,
                 sample_interval=1800.0, domain_mtbf=50000.0,
                 domain_weights={"host": 2.0, "pod": 0.5}, hazard_shape=2.0,
                 hazard_util_weight=1.0, migrate_threshold=0.5, straggler_mtbf=100000.0,
                 spot_fraction=0.25, spot_warning=300.0, num_pods=2, **SMALL)
    got = fsweep.run_cell("dlas", events_path=tmp_path / "p.jsonl", **knobs)
    want = jax_fsweep.run_cell("dlas", events_path=tmp_path / "j.jsonl", **knobs)
    assert got.pop("events") != want.pop("events")
    assert _text(got) == _text(want) and got["delay_by_cause"]
    assert (tmp_path / "p.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()


@pytest.mark.parametrize("policy", ["fifo", "srtf-ckpt", "dlas", "gandiva", "themis"])
def test_net_cell_is_the_jax_packages(policy):
    kw = dict(multislice_share=0.2, num_jobs=40, seed=3, attribution=policy == "dlas")
    got, want = nsweep.run_cell(policy, **kw), jax_nsweep.run_cell(policy, **kw)
    assert got["net_reprices"] > 0 and _text(got) == _text(want)


def test_promotion_and_refusals_are_the_jax_packages():
    from gpuschedule_tpu.sim.philly import generate_philly_like_trace as jax_trace
    from gpuschedule_tpu_torch.sim.philly import generate_philly_like_trace

    got = nsweep.promote_to_multislice(generate_philly_like_trace(50, seed=1), 0.3, 16, seed=1)
    want = jax_nsweep.promote_to_multislice(jax_trace(50, seed=1), 0.3, 16, seed=1)
    assert [(j.job_id, j.num_chips, j.model_name) for j in got] == [
        (j.job_id, j.num_chips, j.model_name) for j in want]
    for call in (lambda m: m.run_cell("fifo", multislice_share=0.1, num_pods=1),
                 lambda m: m.sweep([0.1], ["fifo", "lifo"])):
        msgs = []
        for m in (nsweep, jax_nsweep):
            with pytest.raises(ValueError) as e:
                call(m)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for kw in ({"policies": ["nope"]}, {"workers": 2, "events_path": "x"}):
        msgs = []
        for m in (fsweep, jax_fsweep):
            with pytest.raises(ValueError) as e:
                m.sweep([math.inf], **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_serial_grids_are_the_jax_packages():
    """``sweep`` of both grids in this process (serial), and ``grid_cells``
    in grid order."""
    kw = dict(num_jobs=30, dims=(4, 4), seed=5)
    got = fsweep.sweep([math.inf, 43200.0], ["fifo", "dlas", "gandiva"], **kw)
    want = jax_fsweep.sweep([math.inf, 43200.0], ["fifo", "dlas", "gandiva"], **kw)
    assert _text(got) == _text(want)
    got = nsweep.sweep([0.0, 0.25], ["srtf", "themis"], num_jobs=30, seed=5)
    want = jax_nsweep.sweep([0.0, 0.25], ["srtf", "themis"], num_jobs=30, seed=5)
    assert _text(got) == _text(want)
    cells = fsweep.grid_cells(["a", "b"], [1, 2, 3], lambda k, p: f"{k}{p}")
    assert cells == {"a": ["a1", "a2", "a3"], "b": ["b1", "b2", "b3"]}


def test_serial_grid_retries_as_the_jax_packages():
    """A cell that raises is retried with backoff and logged; one that
    keeps raising fails the grid after ``max_retries``."""
    found = []
    for m in (fsweep, jax_fsweep):
        attempts, log = {}, []

        def run_one(key, pt):
            attempts[(key, pt)] = attempts.get((key, pt), 0) + 1
            if key == "x" and attempts[(key, pt)] < 3:
                raise RuntimeError("transient")
            return [key, pt, attempts[(key, pt)]]

        out = m.grid_cells(["x", "y"], [0, 1], run_one, backoff_s=0.0, retry_log=log)
        with pytest.raises(RuntimeError, match="always"):
            m.grid_cells(["z"], [0], lambda k, p: (_ for _ in ()).throw(RuntimeError("always")),
                         max_retries=1, backoff_s=0.0)
        found.append((out, log))
    assert found[0] == found[1]
    assert found[0][1] == [{"cell": ["x", 0], "round": 1}, {"cell": ["x", 0], "round": 2},
                           {"cell": ["x", 1], "round": 1}, {"cell": ["x", 1], "round": 2}]


def test_faults_line_file_and_streams_are_the_jax_clis(capsys, tmp_path):
    argv = ["faults", "--policies", "fifo,dlas,gandiva,themis,srtf-ckpt", "--num-jobs", "40",
            "--dims", "4x4", "--mtbf", "21600", "--seed", "2", "--events", str(tmp_path / "ev")]
    found = []
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        assert main([*argv, "--out", str(tmp_path / "faults.json")]) == 0
        streams = {p.name: p.read_bytes() for p in sorted((tmp_path / "ev").iterdir())}
        found.append((capsys.readouterr().out, (tmp_path / "faults.json").read_bytes(), streams))
    assert found[0] == found[1]
    line = json.loads(found[1][0])
    assert len(found[1][2]) == 5 and all(c["faults"] > 0 for c in line["cells"])


@pytest.mark.parametrize("argv", [
    ["--restore", "x"],
    ["--policies", "fifo,lifo"],
    ["--policies", "gandiva,nope,also"],
], ids=["restore", "unknown-policy", "two-unknown"])
def test_faults_errors_are_the_jax_clis(capsys, argv):
    msgs = []
    for main in (jax_cli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(["faults", "--num-jobs", "5", *argv])
        msgs.append(str(e.value))
    capsys.readouterr()
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("tool,argv", [
    ("fault_sweep", ["--restore", "x"]),
    ("fault_sweep", ["--ckpt-write", "y"]),
    ("fault_sweep", []),
    ("net_sweep", []),
], ids=["restore", "ckpt-write", "no-out", "net-no-out"])
def test_tool_usage_errors_are_the_jax_tools(capsys, tool, argv):
    """argparse's exit 2 and its message (the program's name aside)."""
    found = []
    for mod in ({"fault_sweep": fault_sweep, "net_sweep": net_sweep}[tool],
                {"fault_sweep": jax_fault_sweep, "net_sweep": jax_net_sweep}[tool]):
        out = [] if argv == [] else ["--out", "o.json"]
        with pytest.raises(SystemExit) as e:
            mod.main([*argv, *out])
        found.append((e.value.code, capsys.readouterr().err.splitlines()[-1].split(": ", 1)[1]))
    assert found[0] == found[1] and found[0][0] == 2


def test_tool_value_errors_are_the_jax_tools(tmp_path):
    for mods, argv in (((fault_sweep, jax_fault_sweep), ["--policies", "fifo,x"]),
                       ((net_sweep, jax_net_sweep), ["--policies", "srtf,fifo-ckpt"]),
                       ((fault_chaos, jax_fault_chaos), ["--policies", "zzz"])):
        msgs = []
        for mod in mods:
            with pytest.raises(ValueError) as e:
                mod.main([*argv, "--out", str(tmp_path / "x.json")])
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("tool", ["fault_sweep", "net_sweep", "fault_chaos"])
def test_small_tool_runs_are_the_jax_tools(capsys, tmp_path, tool):
    """The tools serial in this process: the line (its ``out`` aside) and
    the artifact's bytes."""
    argv = {
        "fault_sweep": ["--mtbfs", "inf,43200", "--policies", "fifo,gandiva,optimus",
                        "--num-jobs", "30", "--dims", "4x4", "--spot", "0.2",
                        "--straggler-mtbf", "90000"],
        "net_sweep": ["--shares", "0,0.3", "--policies", "dlas,fifo-backfill",
                      "--num-jobs", "30", "--ingest", "0.1"],
        "fault_chaos": ["--configs", "2", "--num-jobs", "20", "--policies", "fifo,dlas,themis",
                        "--seed", "4"],
    }[tool]
    found = []
    for side, mod in (("jax", _jax_tool(tool)), ("port", {"fault_sweep": fault_sweep,
                      "net_sweep": net_sweep, "fault_chaos": fault_chaos}[tool])):
        out = tmp_path / f"{side}.json"
        assert mod.main([*argv, "--out", str(out)]) == 0
        line = json.loads(capsys.readouterr().out)
        line.pop("out", None)
        found.append((line, out.read_bytes()))
    assert found[0] == found[1]


@pytest.fixture(scope="module")
def pooled_sweeps(tmp_path_factory):
    """The port's tools with ``--workers 2 --trace`` in processes of their
    own, and the JAX tools the same (their fleet traces), and serial."""
    tmp = tmp_path_factory.mktemp("pooled")
    argvs = {
        "fault_sweep": ["--mtbfs", "inf,43200", "--policies", "fifo,dlas,gandiva",
                        "--num-jobs", "30", "--dims", "4x4"],
        "net_sweep": ["--shares", "0,0.25", "--policies", "srtf,themis", "--num-jobs", "30"],
    }
    procs = {}
    for tool, argv in argvs.items():
        for side, cmd in (("port", ["-m", f"gpuschedule_tpu_torch.tools.{tool}"]),
                          ("jax", [f"tools/{tool}.py"])):
            procs[(tool, side)] = subprocess.Popen(
                [sys.executable, *cmd, *argv, "--workers", "2", "--trace",
                 str(tmp / f"{tool}-{side}.trace.json"), "--out", str(tmp / f"{tool}-{side}.json")],
                cwd=ROOT, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        # the JAX package's serial artifact, in this process (no fork)
        assert _jax_tool(tool).main([*argv, "--out", str(tmp / f"{tool}-serial.json")]) == 0
    for key, proc in procs.items():
        try:
            _, err = proc.communicate(timeout=TIMEOUT_S)
        finally:
            proc.kill()
        assert proc.returncode == 0, (key, err[-3000:])
    return tmp


@pytest.mark.parametrize("tool", ["fault_sweep", "net_sweep"])
def test_pooled_artifact_is_the_jax_serial_one(pooled_sweeps, tool):
    serial = (pooled_sweeps / f"{tool}-serial.json").read_bytes()
    assert (pooled_sweeps / f"{tool}-port.json").read_bytes() == serial
    assert (pooled_sweeps / f"{tool}-jax.json").read_bytes() == serial


@pytest.mark.parametrize("tool", ["fault_sweep", "net_sweep"])
def test_pooled_fleet_trace_has_the_jax_structure(pooled_sweeps, tool):
    shapes = []
    for side in ("port", "jax"):
        with open(pooled_sweeps / f"{tool}-{side}.trace.json") as f:
            shape = chip_smoke.fleet_shape(json.load(f))
        assert set(shape["federation"].pop("workers")) <= {"worker-0", "worker-1"}
        assert set(shape.pop("selfprof_workers")) <= {"worker-0", "worker-1"}
        shapes.append(shape)
    assert shapes[0] == shapes[1]
    assert shapes[1]["federation"]["tasks"] in (6, 4)
    assert shapes[1]["other"]["exporter"] == "gpuschedule_tpu.obs.fleet"


@pytest.fixture(scope="module")
def pool_scenarios(tmp_path_factory):
    """``tests/torch_pool_worker.py`` once a scenario, in processes of
    their own, all at once."""
    tmp = tmp_path_factory.mktemp("pool")
    names = ("order", "crash", "errors", "fleet")
    procs = {n: subprocess.Popen([sys.executable, "tests/torch_pool_worker.py", n, str(tmp / n)],
                                 cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for n in names}
    found = {}
    for n, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=TIMEOUT_S)
        finally:
            proc.kill()
        assert proc.returncode == 0, (n, err[-3000:])
        found[n] = json.loads(out)
    return found


def test_pool_keeps_task_order(pool_scenarios):
    got = pool_scenarios["order"]
    assert got["port"] == got["jax"] == {"out": [10 * i for i in range(11)], "respawns": 0,
                                         "retries": 0}


def test_pool_respawns_a_killed_worker_warm(pool_scenarios):
    """Two tasks each kill their worker once: each dead worker respawned
    and warmed again (the retry reads the broadcast value), two respawns,
    two retries, the lifecycle counters."""
    got = pool_scenarios["crash"]
    assert got["port"] == got["jax"]
    assert got["port"]["out"] == [42, 42] and got["port"]["on_retry"] == [[0, 1], [1, 1]]
    reg = got["port"]["registry"]
    assert reg["pool_worker_respawns_total"]["value"] == 2.0
    assert reg["pool_task_retries_total"]["value"] == 2.0


def test_pool_retries_and_errors(pool_scenarios):
    got = pool_scenarios["errors"]
    assert got["port"] == got["jax"] == {
        "transient": [3, 1], "exhausted": "transient c attempt 3", "retries": 4,
        "crashes": "worker 0 died running task 0", "respawns": 1,
        "zero": "workers must be >= 1, got 0"}


def test_pooled_crash_federates_as_serial(pool_scenarios):
    """A task that kills its worker after counting: the merged registry
    equals the serial run's, and the JAX package's, exactly."""
    port, jax = (dict(pool_scenarios["fleet"][s]) for s in ("port", "jax"))
    for side in (port, jax):
        assert set(side.pop("federation")["workers"]) <= {"worker-0", "worker-1"}
        assert side["serial_registry"] == side["pooled_registry"]
    assert port == jax
    assert port["respawns"] == port["retries"] == 1 and port["pooled"] == [0, 1, 4, 9]
    assert port["doc_registry"]["pool_worker_respawns_total"]["value"] == 1.0
    assert sorted(s[:2] for s in port["worker_spans"]) == sorted(
        [[name, i] for i in range(4) for name in ("square", "task")])


def test_unpicklable_result_becomes_a_remote_error():
    """A worker whose result cannot be pickled back sends a ``RemoteError``
    carrying the traceback instead (the worker loop with queues that
    pickle on ``put``, in this process, for both packages)."""

    class Pickling(queue.Queue):
        def put(self, item, *a, **kw):
            import pickle

            pickle.dumps(item)
            super().put(item, *a, **kw)

    for mod in (pool, jax_pool):
        req, res = queue.Queue(), Pickling()
        req.put((7, lambda: lambda: None, ()))
        req.put((8, divmod, (7, 2)))
        req.put(None)
        mod._worker_main(3, req, res)
        wid, task, ok, err = res.get()
        assert (wid, task, ok, type(err).__name__) == (3, 7, False, "RemoteError")
        assert str(err).startswith("task 7 result not picklable: Traceback")
        assert res.get() == (3, 8, True, (3, 1))


def test_pool_spawns_once_torch_has_worked(monkeypatch):
    """The one departure from the JAX pool: a process whose torch has a
    CUDA context, or whose profiler harness has measured a step, gets
    spawned workers; otherwise the platform's default (``whatif``'s
    online Optimus on the CPU runs through it in
    ``tests/test_torch_whatif.py``)."""
    import multiprocessing

    from gpuschedule_tpu_torch.profiler import harness

    monkeypatch.setattr(harness, "STEPS_MEASURED", False)
    idle = types.SimpleNamespace(cuda=types.SimpleNamespace(is_initialized=lambda: False))
    monkeypatch.setitem(sys.modules, "torch", idle)
    assert pool.default_context() is multiprocessing.get_context()
    monkeypatch.setattr(harness, "STEPS_MEASURED", True)
    assert pool.default_context().get_start_method() == "spawn"
    monkeypatch.setattr(harness, "STEPS_MEASURED", False)
    busy = types.SimpleNamespace(cuda=types.SimpleNamespace(is_initialized=lambda: True))
    monkeypatch.setitem(sys.modules, "torch", busy)
    assert pool.default_context().get_start_method() == "spawn"


def test_engine_bench_gate_and_ladder():
    """The gate's logic with floors the test passes in, the ratios, and a
    small rung's replay (its counts, not its times) against the JAX tool's;
    the floors file gates the same configurations as the JAX package's."""
    rungs = [{"config": "plain", "num_jobs": 100, "jobs_per_s": 500.0},
             {"config": "plain", "num_jobs": 1000, "jobs_per_s": 450.0},
             {"config": "net", "num_jobs": 100, "jobs_per_s": 90.0},
             {"config": "nofloor", "num_jobs": 100, "jobs_per_s": 1.0}]
    floors = {"plain": 400.0, "net": 100.0}
    for mod in (engine_bench, jax_engine_bench):
        gate = mod.apply_gate(rungs, floors=floors)
        assert not gate["ok"] and [c["ok"] for c in gate["checked"]] == [True, True, False]
        assert mod.apply_gate(rungs, floors=floors, floor_scale=0.5)["ok"]
        assert mod.scale_ratios(rungs)["plain"] == {"1000/100": 0.9}
    assert set(engine_bench.FLOORS) == set(jax_engine_bench.FLOORS)
    assert engine_bench.DEFAULT_CONFIGS == jax_engine_bench.DEFAULT_CONFIGS
    times = ("elapsed_s", "jobs_per_s", "events_per_s", "rss_peak_mb")
    for config in ("faults", "net-v2", "attrib"):
        got = engine_bench.run_rung(config, 60, seed=1)
        want = jax_engine_bench.run_rung(config, 60, seed=1)
        assert {k: v for k, v in got.items() if k not in times} == {
            k: v for k, v in want.items() if k not in times}
    got = engine_bench.run_snapshot_rung(60, seed=1)
    want = jax_engine_bench.run_snapshot_rung(60, seed=1)
    keep = ("paused_at_s", "running", "pending", "finished")
    assert {k: got[k] for k in keep} == {k: want[k] for k in keep}
