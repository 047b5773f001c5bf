"""Port parity for ``whatif`` (``sim/whatif.py`` and the subcommand), at
tolerance zero but for the wall clock.

The query grammar and its errors, the canonical result documents
(``canonical_document``: without the latency readings) of admit, drain
and policy-swap queries in this process (``--pool 0``) and pooled in a
process of its own (``--pool 2``: the pool forks, and a pytest process
that has run JAX and torch must not), a mirror resumed from a snapshot,
the history rows without their time stamp and latency, the ``--prom``
families without the latency buckets, the merged fleet trace by
structure, and the CLI's refusals word for word.  Last, one of
``chip_smoke.py`` phase 23's pins recomputed from the JAX package.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
from torch_sim_parity import ROOT

import chip_smoke
from gpuschedule_tpu import cli as jax_cli
from gpuschedule_tpu.obs import fleet as jax_fleet
from gpuschedule_tpu.sim import whatif as jax_whatif
from gpuschedule_tpu_torch import cli
from gpuschedule_tpu_torch.obs import fleet
from gpuschedule_tpu_torch.sim import whatif

TIMEOUT_S = 120
ENV = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}
WORLD = ["--synthetic", "30", "--seed", "5", "--cluster", "tpu-v5e", "--dims", "4x4",
         "--pods", "2", "--policy", "dlas", "--faults", "mtbf=50000,repair=600",
         "--net", "os=2", "--at", "2000", "--horizon", "30000"]
QUERIES = ["--admit", "chips=8,duration=3600,pods=0:1", "--admit",
           "chips=4,duration=1800,model=transformer-small,at=2500,job_id=mine",
           "--drain", "pod=1,at=3000,duration=7200", "--swap-policy", "srtf"]
N_QUERIES = 5


def _whatif_both(capsys, tmp_path, argv):
    """``whatif`` through both CLIs in this process, each with ``--out``,
    ``--history``, ``--prom`` and ``--trace-out`` of its own."""
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = tmp_path / side
        assert main(["whatif", *argv, "--out", str(d / "w.json"), "--history",
                     str(d / "h.db"), "--prom", str(d / "w.prom"), "--trace-out",
                     str(d / "t.json")]) == 0
    capsys.readouterr()
    return tmp_path / "jax", tmp_path / "port"


@pytest.mark.parametrize("spec", [
    "chips=8,duration=3600", "chips=8,duration=3600,pods=0:2:5", " chips = 4 , duration=60,"
    "model=m,at=7,job-id=j", "chips=2,duration=9,pods=", "chips=0,duration=5", "chips=3",
    "chips=3,duration=0", "chips=3,duration=5,color=red", "chips=3,duration", ""])
def test_admit_spec_is_the_jax_packages(spec):
    assert _outcome(whatif.parse_admit_spec, spec) == _outcome(jax_whatif.parse_admit_spec, spec)


@pytest.mark.parametrize("spec", ["pod=7", "pod=2,at=100,duration=60", "at=5", "pod=1,x=2",
                                  "pod"])
def test_drain_spec_is_the_jax_packages(spec):
    assert _outcome(whatif.parse_drain_spec, spec) == _outcome(jax_whatif.parse_drain_spec, spec)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("query", [
    {"kind": "admit", "chips": 8, "duration": 60}, {"kind": "admit", "chips": 0, "duration": 60},
    {"kind": "admit", "chips": 8}, {"kind": "drain", "scope": ["pod", "3"], "at": 5},
    {"kind": "drain", "scope": ["pod"]}, {"kind": "policy-swap", "policy": "fifo"},
    {"kind": "policy-swap"}, {"kind": "grow"},
    {"kind": "admit", "chips": "8", "duration": 3600, "pod": "1", "at": 10},
])
def test_query_validation_is_the_jax_packages(query):
    for fn in ("validate_query", "normalize_query"):
        assert _outcome(getattr(whatif, fn), dict(query)) == _outcome(
            getattr(jax_whatif, fn), dict(query))


def test_serial_documents_are_the_jax_clis(capsys, tmp_path):
    """Admits (one pinned to each of two pods, one unpinned of a named
    model at a later instant), a drain and a policy swap, in process: the
    canonical documents, the history rows, the ``--prom`` families and
    the fleet trace's structure are the JAX CLI's."""
    jax_dir, port_dir = _whatif_both(capsys, tmp_path, [*WORLD, *QUERIES])
    docs = [json.loads((d / "w.json").read_text()) for d in (jax_dir, port_dir)]
    assert whatif.canonical_document(docs[0]) == whatif.canonical_document(docs[1])
    assert [q["query"]["kind"] for q in docs[1]["queries"]] == [
        "admit", "admit", "admit", "drain", "policy-swap"]
    assert docs[1]["latency_ms"]["count"] == N_QUERIES and docs[1]["pool"] == 0
    assert docs[1]["queries"][2]["admitted"]["job_id"] == "mine"
    hist = [chip_smoke.whatif_history(d / "h.db") for d in (jax_dir, port_dir)]
    assert hist[0] == hist[1] and hist[1][1] is None
    prom = [chip_smoke.prom_families((d / "w.prom").read_text()) for d in (jax_dir, port_dir)]
    assert prom[0] == prom[1] and prom[1][1] == []
    shapes = [chip_smoke.fleet_shape(json.loads((d / "t.json").read_text()))
              for d in (jax_dir, port_dir)]
    assert shapes[0] == shapes[1]
    assert shapes[1]["federation"] == {"tasks": N_QUERIES, "workers": ["worker-local"]}


@pytest.fixture(scope="module")
def pooled(tmp_path_factory):
    """``whatif --pool 2`` through the port's CLI and the JAX CLI, and a
    small ``tools.whatif_bench``, each in a process of its own, at once;
    then the JAX CLI's ``--pool 0`` run in this process."""
    tmp = tmp_path_factory.mktemp("pooled")
    procs = {}
    for side, cmd in (("port", ["-m", "gpuschedule_tpu_torch"]),
                      ("jax", ["-m", "gpuschedule_tpu.cli"])):
        d = tmp / side
        procs[side] = subprocess.Popen(
            [sys.executable, *cmd, "whatif", *WORLD, *QUERIES, "--pool", "2",
             "--out", str(d / "w.json"), "--history", str(d / "h.db"),
             "--prom", str(d / "w.prom"), "--trace-out", str(d / "t.json")],
            cwd=ROOT, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # Optimus online on the CPU: the parent profiles the trace's model, then
    # a pooled admit of another model (a forked worker would hang in
    # torch's thread pool; the pool spawns)
    (tmp / "online").mkdir()
    (tmp / "online" / "t.csv").write_text(
        "job_id,submit_time,num_chips,duration,model_name\n"
        + "".join(f"j{i},{30 * i},{4 << (i % 2)},{3000 + 500 * i},transformer-tiny\n"
                  for i in range(4)))
    procs["online"] = subprocess.Popen(
        [sys.executable, "-m", "gpuschedule_tpu_torch", "whatif", "--policy", "optimus",
         "--online", "--curves", str(tmp / "online" / "c.json"), "--device", "cpu",
         "--trace", str(tmp / "online" / "t.csv"), "--cluster", "tpu-v5e", "--dims", "4x4",
         "--at", "100", "--pool", "2", "--admit", "chips=4,duration=600,model=transformer-small",
         "--out", str(tmp / "online" / "w.json")],
        cwd=ROOT, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs["bench"] = subprocess.Popen(
        [sys.executable, "-m", "gpuschedule_tpu_torch.tools.whatif_bench", "--jobs", "300",
         "--queries", "4", "--pool", "2", "--repeats", "1", "--no-gate"],
        cwd=ROOT, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    d = tmp / "serial"
    assert jax_cli.main(["whatif", *WORLD, *QUERIES, "--out", str(d / "w.json"),
                         "--history", str(d / "h.db"), "--prom", str(d / "w.prom"),
                         "--trace-out", str(d / "t.json")]) == 0
    found = {}
    for key, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=TIMEOUT_S)
        finally:
            proc.kill()
        assert proc.returncode == 0, (key, err[-3000:])
        found[key] = out
    return tmp, found


def test_pooled_document_is_the_jax_serial_one(pooled):
    tmp, _ = pooled
    want = chip_smoke.whatif_canonical_sha(tmp / "serial" / "w.json")
    for side in ("port", "jax"):
        assert chip_smoke.whatif_canonical_sha(tmp / side / "w.json") == want
    doc = json.loads((tmp / "port" / "w.json").read_text())
    assert doc["pool"] == 2 and len(doc["queries"]) == N_QUERIES


def test_pooled_history_and_prom_are_the_jax_clis(pooled):
    tmp, _ = pooled
    rows, pool_row = chip_smoke.whatif_history(tmp / "port" / "h.db")
    assert rows == chip_smoke.whatif_history(tmp / "serial" / "h.db")[0]
    assert pool_row == chip_smoke.whatif_history(tmp / "jax" / "h.db")[1] == {
        "workers": 2, "respawns": 0, "retries": 0, "queries": N_QUERIES}
    prom, pool_lines = chip_smoke.prom_families((tmp / "port" / "w.prom").read_text())
    assert prom == chip_smoke.prom_families((tmp / "serial" / "w.prom").read_text())[0]
    assert pool_lines == ["pool_task_retries_total 0", "pool_worker_respawns_total 0"]


def test_pooled_fleet_trace_passes_the_structure_check(pooled):
    """``chip_smoke.check_fleet`` on the port's pooled trace, and its
    structure equal to the JAX CLI's pooled trace's."""
    tmp, _ = pooled
    doc = json.loads((tmp / "port" / "w.json").read_text())
    got = chip_smoke.check_fleet(
        tmp / "port" / "t.json", trace_id=doc["run_id"], tasks=N_QUERIES, pool=2,
        parent=("enqueue", "dispatch", "reassemble"),
        worker_spans={"task": 1, "fork": 1, "restore": 1, "mutate": 1, "replay": 1, "diff": 1},
        counters={"whatif_queries_total": {'{kind="admit"}': 3.0, '{kind="drain"}': 1.0,
                                           '{kind="policy-swap"}': 1.0},
                  "pool_worker_respawns_total": 0.0})
    assert got["tasks"] == N_QUERIES
    shapes = []
    for side in ("port", "jax"):
        shape = chip_smoke.fleet_shape(json.loads((tmp / side / "t.json").read_text()))
        assert set(shape["federation"].pop("workers")) <= {"worker-0", "worker-1"}
        shapes.append(shape)
    assert shapes[0] == shapes[1]


def test_online_profiling_pool_spawns_and_profiles(pooled):
    """The parent profiled transformer-tiny (the trace's model), then a
    spawned worker profiled transformer-small (the admitted one) into the
    same curve file."""
    tmp, _ = pooled
    curves = json.loads((tmp / "online" / "c.json").read_text())
    assert sorted(curves) == ["transformer-small", "transformer-tiny"]
    assert all(c["source"].startswith("measured") for c in curves.values())
    doc = json.loads((tmp / "online" / "w.json").read_text())
    assert doc["queries"][0]["admitted"]["end_state"] == "done"


def test_whatif_bench_runs_pooled(pooled):
    _, found = pooled
    line = json.loads(found["bench"].strip().splitlines()[-1])
    assert set(line) == {"serial_s", "serial_warm_s", "pool_s", "speedup", "p50_ms", "p95_ms",
                         "ok"}
    assert line["pool_s"] > 0 and line["p50_ms"] > 0


def test_resumed_mirror_is_the_jax_packages(capsys, tmp_path):
    """Each package's own snapshot of one replay, then ``whatif --resume``
    from it: equal canonical documents; a mirror instant before the
    snapshot's is refused with the JAX CLI's words."""
    run = ["run", "--policy", "dlas", "--cluster", "tpu-v5e", "--dims", "4x4", "--synthetic",
           "40", "--seed", "8", "--snapshot-every", "20000"]
    found, refusals = [], []
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        snap = str(tmp_path / f"{side}.pkl")
        assert main([*run, "--snapshot", snap]) == 0
        assert main(["whatif", "--resume", snap, "--at", "40000", "--admit",
                     "chips=4,duration=3600,at=41000", "--swap-policy", "fifo",
                     "--out", str(tmp_path / f"{side}.json")]) == 0
        found.append(whatif.canonical_document(
            json.loads((tmp_path / f"{side}.json").read_text())))
        with pytest.raises(SystemExit) as e:
            main(["whatif", "--resume", snap, "--at", "10", "--swap-policy", "fifo"])
        refusals.append(str(e.value).replace(snap, "SNAP"))
    capsys.readouterr()
    assert found[0] == found[1] and found[1]["requested_at_s"] == 40000.0
    assert refusals[0] == refusals[1] and "before the snapshot instant" in refusals[1]


@pytest.mark.parametrize("argv", [
    [*WORLD],
    [*WORLD[:-4], "--at", "-1", "--swap-policy", "fifo"],
    [*WORLD, "--admit", "chips=4,duration=60,at=100"],
    [*WORLD, "--admit", "chips=4,duration=60,at=900000"],
    [*WORLD, "--drain", "pod=0,at=500000"],
    ["--synthetic", "10", "--cluster", "tpu-v5e", "--dims", "4x4", "--pods", "2",
     "--placement", "contention", "--at", "10", "--swap-policy", "fifo"],
    [*WORLD, "--admit", "chips=4"],
    [*WORLD, "--drain", "node=1"],
    [*WORLD, "--horizon", "0", "--swap-policy", "fifo"],
    [*WORLD, "--max-time", "6000", "--admit", "chips=4,duration=600,at=7000"],
    ["--resume", "no-such-snapshot.pkl", "--at", "10", "--swap-policy", "fifo"],
], ids=["no-query", "negative-at", "before-mirror", "beyond-horizon", "drain-beyond",
        "contention-without-net", "admit-spec", "drain-spec", "zero-horizon",
        "beyond-max-time", "missing-snapshot"])
def test_refusals_are_the_jax_clis(capsys, argv):
    msgs = []
    for main in (jax_cli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(["whatif", *argv])
        msgs.append(str(e.value))
    capsys.readouterr()
    assert msgs[0] == msgs[1] and msgs[1]


def _traced_square(mod, i):
    with mod.task_span("square", i=i):
        return i * i


def _square_port(i):
    return _traced_square(fleet, i)


def _square_jax(i):
    return _traced_square(jax_fleet, i)


def test_fleet_merge_is_deterministic_under_completion_order():
    """Payloads absorbed in task order and scrambled give one document;
    its structure is the JAX collector's for the same payloads."""
    docs = {}
    for name, mod, fn in (("port", fleet, _square_port), ("jax", jax_fleet, _square_jax)):
        payloads = {i: mod.run_task(fn, mod.TaskContext("t", "dispatch", i), (i,))
                    for i in range(4)}
        worker_of = {0: 0, 1: 1, 2: 0, 3: 1}
        orders = []
        for order in ([0, 1, 2, 3], [3, 1, 0, 2], [2, 3, 1, 0]):
            fc = mod.FleetCollector("t", parent="test")
            with fc.span("dispatch", tasks=4):
                for i in order:
                    assert fc.absorb(i, worker_of[i], payloads[i]) == i * i
            doc = fc.document()
            for e in doc["traceEvents"]:
                if e["pid"] == 1 and e["ph"] == "X":
                    e["ts"] = e["dur"] = 0  # the parent span's own time
            orders.append(json.dumps(doc, sort_keys=True))
        assert len(set(orders)) == 1
        docs[name] = json.loads(orders[0])
        assert mod.active() is None
    assert chip_smoke.fleet_shape(docs["port"]) == chip_smoke.fleet_shape(docs["jax"])
    assert docs["port"]["federation"] == {"tasks": 4, "workers": ["worker-0", "worker-1"]}


def test_net_sweep_pin_is_the_jax_packages(tmp_path, capsys):
    """``chip_smoke.SWEEP_PINS["ns.json"]``, the net sweep's artifact at
    its defaults, recomputed from the JAX tool (serial, ~8 s)."""
    spec = importlib.util.spec_from_file_location("jax_net_sweep", ROOT / "tools" / "net_sweep.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.main(["--out", str(tmp_path / "ns.json")]) == 0
    capsys.readouterr()
    assert chip_smoke._sha((tmp_path / "ns.json").read_text()) == chip_smoke.SWEEP_PINS["ns.json"]
