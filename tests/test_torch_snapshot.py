"""Port parity for v2 accounting and the engine's snapshots.

``--accounting v2`` (``sim/ledger.py``): the port's summaries and files
equal the JAX package's to the bit under FIFO (the lazy path, no per-batch
sweep), DLAS and Gandiva (the ledger's ``sync_all``, vector and scalar),
with attribution, faults and the fabric.  Snapshots (``sim/snapshot.py``):
a snapshot taken mid-replay, restored in this process or in a fresh one
and finished, gives the uninterrupted run's files byte for byte, and so
the JAX package's; a fork runs on without moving its parent; a bad file
raises the JAX package's ``SnapshotError``.  A port snapshot pickles the
port's classes, so parity is on what a resume produces, not on the
snapshot's bytes.
"""

import contextlib
import hashlib
import io
import json
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from gpuschedule_tpu import cli as jax_cli
from gpuschedule_tpu.sim import Simulator as JaxSimulator
from gpuschedule_tpu.sim import ledger as jax_ledger, snapshot as jax_snapshot
from gpuschedule_tpu_torch import cli
from gpuschedule_tpu_torch.sim import Simulator
from gpuschedule_tpu_torch.sim import ledger, snapshot
from gpuschedule_tpu_torch.sim.engine import Simulator as Engine

from torch_sim_parity import PHILLY_SAMPLE, ROOT, errors_alike, run_both

SIDES = (("jax", jax_cli.main, JaxSimulator), ("port", cli.main, Simulator))
STREAMS = ("events.jsonl", "jobs.csv", "utilization.csv", "counters.json")
# faults, the fabric and attribution all armed, small enough for tier-1
WORLD = [
    "--synthetic", "12", "--seed", "5", "--cluster", "tpu-v5e",
    "--dims", "4x4", "--pods", "2", "--policy", "dlas",
    "--faults", "mtbf=5000,repair=600,straggler_mtbf=9000,straggler_degrade=0.5",
    "--net", "os=2", "--attrib",
]
V2_CASES = {
    # the lazy path: FIFO reads no running progress, so no per-batch sweep
    "fifo": ["--policy", "fifo", "--philly", PHILLY_SAMPLE],
    # the ledger's sync_all, over and under its scalar cutover
    "dlas": ["--policy", "dlas", "--philly", PHILLY_SAMPLE],
    "dlas-attrib": ["--policy", "dlas", "--philly", PHILLY_SAMPLE, "--attrib"],
    "gandiva": ["--policy", "gandiva", "--cluster", "gpu", "--philly", PHILLY_SAMPLE],
    "dlas-faults": ["--policy", "dlas", "--synthetic", "150", "--seed", "2", "--attrib",
                    "--faults", "mtbf=40000,repair=3600,ckpt=1800,ckpt_write=auto"],
    "dlas-net": ["--policy", "dlas", "--cluster", "tpu-v5e", "--dims", "4x4", "--pods", "4",
                 "--synthetic", "200", "--seed", "3", "--net"],
}


def _sha(p: Path) -> str:
    return hashlib.sha256(p.read_bytes()).hexdigest()


def _keep_first_snapshot(monkeypatch, cls, early: Path) -> None:
    """Stash the first periodic snapshot aside: everything after it must
    replay on resume."""
    orig = cls.snapshot

    def keep_first(self, path):
        orig(self, path)
        if self._snap_writes == 1:
            shutil.copy2(path, early)

    monkeypatch.setattr(cls, "snapshot", keep_first)


@pytest.mark.parametrize("case", sorted(V2_CASES))
def test_v2_replays_equal_jax(case, capsys, tmp_path):
    """v2 summaries, files and event streams equal the JAX package's."""
    got = run_both(capsys, tmp_path, [*V2_CASES[case], "--accounting", "v2", "--events"],
                   files=("jobs.csv", "utilization.csv", "counters.json", "metrics.prom",
                          "metrics.json", "events.jsonl"))
    assert got["num_finished"] + got["num_unfinished"] == got["arrivals"]


def test_v2_ledger_takes_both_sync_paths(capsys, monkeypatch):
    """DLAS on the Philly sample drives ``sync_all`` above and below
    ``SCALAR_CUTOVER`` (the vector and the scalar path); FIFO never."""
    assert ledger.SCALAR_CUTOVER == jax_ledger.SCALAR_CUTOVER
    seen = {"fifo": set(), "dlas": set()}
    orig = ledger.JobLedger.sync_all
    for policy in seen:
        def sync(self, t, policy=policy):
            seen[policy].add(self._n >= ledger.SCALAR_CUTOVER)
            return orig(self, t)

        monkeypatch.setattr(ledger.JobLedger, "sync_all", sync)
        assert cli.main(["run", "--policy", policy, "--philly", PHILLY_SAMPLE,
                         "--accounting", "v2"]) == 0
    capsys.readouterr()
    assert seen == {"fifo": set(), "dlas": {True, False}}


def test_v2_differs_from_v1_only_in_float_order(capsys):
    """v2 replaces byte-identity with closure: the same jobs finish and
    are preempted as under v1."""
    lines = {}
    for acc in ("v1", "v2"):
        assert cli.main(["run", *V2_CASES["dlas"], "--accounting", acc]) == 0
        lines[acc] = json.loads(capsys.readouterr().out)
    for key in ("num_finished", "num_done", "arrivals", "preemptions"):
        assert lines["v1"][key] == lines["v2"][key], key


@pytest.fixture(scope="module")
def snapshotted(tmp_path_factory):
    """For each package: the uninterrupted run (``a``), the same run with
    periodic snapshots (``b``, its outputs equal to ``a``'s: snapshots are
    observational) and its first snapshot (``early.ckpt``).  Then the
    crash: a garbage tail on ``b``'s stream, its end-of-run files gone."""
    tmp = tmp_path_factory.mktemp("snap")
    found = {}
    for side, main, cls in SIDES:
        a, b, early = tmp / side / "a", tmp / side / "b", tmp / side / "early.ckpt"
        with pytest.MonkeyPatch.context() as m, contextlib.redirect_stdout(io.StringIO()):
            assert main(["run", *WORLD, "--out", str(a), "--events"]) == 0
            _keep_first_snapshot(m, cls, early)
            assert main(["run", *WORLD, "--out", str(b), "--events", "--snapshot",
                         str(tmp / side / "rolling.ckpt"), "--snapshot-every", "20000"]) == 0
        assert early.exists(), "no mid-replay snapshot was written"
        for name in STREAMS:
            assert _sha(a / name) == _sha(b / name), name
        with open(b / "events.jsonl", "a") as f:
            f.write('{"event": "garbage-from-crashed-tail')
        for name in STREAMS[1:]:
            (b / name).unlink()
        found[side] = (a, b, early)
    return found


@pytest.mark.parametrize("where", ["in-process", "subprocess"])
def test_resume_finishes_as_the_uninterrupted_run(where, snapshotted, tmp_path, capsys):
    """The first snapshot resumed onto a copy of the crashed stream: the
    restore truncates the garbage tail at the recorded offset and appends,
    and each file equals the uninterrupted run's bytes, and so the JAX
    package's.  In this process through both CLIs, or in a fresh
    ``python -m gpuschedule_tpu_torch run --resume`` (new ids, interned
    strings and registries: what the format exists for)."""
    resumed = {}
    for side, main, _ in SIDES:
        if where == "subprocess" and side == "jax":
            continue
        _, crashed, early = snapshotted[side]
        b = tmp_path / side
        shutil.copytree(crashed, b)
        argv = ["run", "--resume", str(early), "--out", str(b), "--events",
                str(b / "events.jsonl")]
        if where == "subprocess":
            proc = subprocess.run([sys.executable, "-m", "gpuschedule_tpu_torch", *argv],
                                  cwd=ROOT, capture_output=True, text=True, timeout=120)
            assert proc.returncode == 0, proc.stderr
            line = proc.stdout
        else:
            assert main(argv) == 0
            line = capsys.readouterr().out
        assert json.loads(line.strip().splitlines()[-1])["num_finished"] == 12
        resumed[side] = b
    for side, b in resumed.items():
        for name in STREAMS:
            assert _sha(b / name) == _sha(snapshotted[side][0] / name), (side, name)
            assert _sha(b / name) == _sha(snapshotted["jax"][0] / name), (side, name)


def test_jax_snapshot_is_refused_without_importing_jax(snapshotted):
    """A JAX-package snapshot carries ``MAGIC`` and ``SNAPSHOT_VERSION``
    too; the port's loader refuses it by its classes' module, and a fresh
    ``run --resume`` exits with that error before anything of the JAX
    package is imported."""
    jax_early = snapshotted["jax"][2]
    with pytest.raises(snapshot.SnapshotError, match="snapshot of another package "
                                                     r"\(gpuschedule_tpu\."):
        snapshot.load_snapshot(jax_early)
    code = ("import sys\n"
            "from gpuschedule_tpu_torch.cli import main\n"
            "try:\n"
            "    main(['run', '--resume', sys.argv[1]])\n"
            "except SystemExit as e:\n"
            "    print(e)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'gpuschedule_tpu'))\n")
    proc = subprocess.run([sys.executable, "-c", code, str(jax_early)], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    msg, imported = proc.stdout.strip().splitlines()[-2:]
    assert msg.startswith(f"{jax_early}: snapshot of another package (gpuschedule_tpu.")
    assert imported == "[]"


def test_fork_is_independent_of_its_parent(tmp_path):
    """A fork finishes as the JAX package's fork does; the parent then
    finishes as the uninterrupted run, and the fork wrote nothing."""
    from gpuschedule_tpu.cluster import TpuCluster as JaxTpu
    from gpuschedule_tpu.policies import make_policy as jax_make_policy
    from gpuschedule_tpu.sim.metrics import MetricsLog as JaxLog
    from gpuschedule_tpu.sim.philly import load_philly_csv as jax_load
    from gpuschedule_tpu_torch.cluster import TpuCluster
    from gpuschedule_tpu_torch.policies import make_policy
    from gpuschedule_tpu_torch.sim.metrics import MetricsLog
    from gpuschedule_tpu_torch.sim.philly import load_philly_csv

    got = {}
    for side, cls, tpu, make, log_cls, load in (
            ("jax", JaxSimulator, JaxTpu, jax_make_policy, JaxLog, jax_load),
            ("port", Simulator, TpuCluster, make_policy, MetricsLog, load_philly_csv)):
        def world(sink=None):
            log = log_cls(record_events=sink is not None, events_sink=sink)
            return cls(tpu("v5e", dims=(8, 8)), make("dlas"), load(PHILLY_SAMPLE),
                       metrics=log), log

        whole, _ = world()
        whole = whole.run().summary()
        sink = tmp_path / f"{side}.events.jsonl"
        sim, log = world(sink)
        sim.run_until(60_000.0)
        log.flush_events()
        head = sink.read_bytes()
        fork = sim.fork()
        fork.swap_policy(make("fifo"))
        forked = fork.run().summary()
        assert sink.read_bytes() == head  # the fork writes into no stream
        with log:
            parent = sim.run().summary()
        assert parent == whole
        got[side] = (forked, parent, _sha(sink))
    assert got["port"] == got["jax"]
    assert got["port"][0] != got["port"][1]


@pytest.mark.parametrize("kind", ["bad-magic", "corrupt", "wrong-version", "missing"])
def test_bad_snapshot_raises_the_jax_error(kind, tmp_path, capsys):
    """Each bad file raises ``SnapshotError`` with the JAX package's
    message; the CLI exits with it."""
    assert snapshot.MAGIC == jax_snapshot.MAGIC
    assert snapshot.SNAPSHOT_VERSION == jax_snapshot.SNAPSHOT_VERSION
    path = tmp_path / "s.ckpt"
    if kind == "bad-magic":
        path.write_bytes(b"not a snapshot at all")
    elif kind == "corrupt":
        path.write_bytes(snapshot.MAGIC + b"\x80\x04garbage")
    elif kind == "wrong-version":
        path.write_bytes(snapshot.MAGIC + pickle.dumps(
            {"version": snapshot.SNAPSHOT_VERSION + 1, "state": {}}))
    msgs = []
    for mod in (jax_snapshot, snapshot):
        with pytest.raises(mod.SnapshotError) as e:
            mod.load_snapshot(path)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert issubclass(snapshot.SnapshotError, ValueError)
    assert errors_alike(capsys, ["--resume", str(path)]) == msgs[1]


@pytest.mark.parametrize("argv", [
    ["--snapshot", "{tmp}/x.ckpt"],
    ["--snapshot-every", "100"],
    ["--snapshot", "{tmp}/x.ckpt", "--snapshot-every", "-10"],
    ["--snapshot", "{tmp}/x.ckpt", "--snapshot-every", "nan"],
    ["--spans"], ["--perfetto", "{tmp}/t.json"], ["--prom", "{tmp}/m.prom"],
    ["--flush-events", "0"], ["--events"],
], ids=lambda a: "_".join(a).replace("{tmp}/", ""))
def test_resume_flag_errors_equal_jax(argv, snapshotted, tmp_path, capsys):
    """``run --resume`` refuses what the JAX CLI refuses, in its words."""
    early = snapshotted["port"][2]
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    errors_alike(capsys, ["--resume", str(early), *argv])


def test_v2_resume_is_closure_exact(tmp_path, monkeypatch):
    """Under v2 a restore rebuilds the ledger from the running set and the
    resumed summary equals the uninterrupted v2 run's, and the JAX
    package's (``docs/performance.md``: v2's contract is exact-sum
    closure under its own summation order)."""
    from gpuschedule_tpu.cluster import SimpleCluster as JaxSimple
    from gpuschedule_tpu.policies import make_policy as jax_make_policy
    from gpuschedule_tpu.sim.trace import generate_poisson_trace as jax_poisson
    from gpuschedule_tpu_torch.cluster import SimpleCluster
    from gpuschedule_tpu_torch.policies import make_policy
    from gpuschedule_tpu_torch.sim.trace import generate_poisson_trace

    got = {}
    for side, cls, simple, make, poisson in (
            ("jax", JaxSimulator, JaxSimple, jax_make_policy, jax_poisson),
            ("port", Engine, SimpleCluster, make_policy, generate_poisson_trace)):
        def world():
            return cls(simple(64), make("dlas"), poisson(300, seed=11), accounting="v2")

        whole = world().run().summary()
        early = tmp_path / f"{side}.early.ckpt"
        with monkeypatch.context() as m:
            _keep_first_snapshot(m, cls, early)
            sim = world()
            sim._snap_every = sim._snap_next = 50_000.0
            sim._snap_path = tmp_path / f"{side}.mid.ckpt"
            assert sim.run().summary() == whole
        assert sim._snap_writes >= 1
        restored = cls.restore(early)
        assert restored._lazy and restored._lv is not None
        assert restored._lv._n == len(restored.running)
        got[side] = restored.run().summary()
        assert got[side] == whole
    assert got["port"] == got["jax"]


def test_snapshot_skips_name_the_ports_attributes():
    """The attributes a snapshot leaves out or copies by name exist on
    the port's engine and metrics log, as they do on the JAX package's."""
    from gpuschedule_tpu_torch.cluster import SimpleCluster
    from gpuschedule_tpu_torch.policies import make_policy

    assert snapshot._ENGINE_SKIP == jax_snapshot._ENGINE_SKIP
    assert snapshot._METRICS_FIELDS == jax_snapshot._METRICS_FIELDS
    sim = Simulator(SimpleCluster(8), make_policy("fifo"), [])
    assert snapshot._ENGINE_SKIP <= set(vars(sim))
    assert set(snapshot._METRICS_FIELDS) <= set(vars(sim.metrics))
