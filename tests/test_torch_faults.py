"""Port parity for fault injection (``faults/``), the failure hazard and the
shared DCN fabric (``net/``), at tolerance zero.

Each fault process runs through both packages' CLIs under FIFO,
Tiresias-DLAS, Gandiva and Themis: the summary lines must be equal and
every file under ``--out`` byte-equal, and each process must have fired.
Then the fabric on eight 16-chip v5e pods, the GPU cluster's domains and
stragglers, the generated schedules, ``inject_drain`` through both
engines, the spec parsers' errors, the copied defaults, and the net
summary that ``chip_smoke.py`` pins, recomputed from the JAX package.
"""

import dataclasses
import io
import json
import math
import sys
from contextlib import redirect_stdout

import pytest
from torch_sim_parity import ROOT, counters, errors_alike, run_both

from gpuschedule_tpu import cli as jax_cli
from gpuschedule_tpu.cluster import GpuCluster as JaxGpu, TpuCluster as JaxTpu
from gpuschedule_tpu.faults import hazard as jax_hazard, recovery as jax_recovery
from gpuschedule_tpu.faults import schedule as jax_schedule
from gpuschedule_tpu.net import model as jax_net
from gpuschedule_tpu.policies import make_policy as jax_make_policy
from gpuschedule_tpu.sim import Simulator as JaxSimulator
from gpuschedule_tpu.sim.trace import generate_poisson_trace as jax_trace
from gpuschedule_tpu_torch.cluster import GpuCluster, TpuCluster
from gpuschedule_tpu_torch.faults import hazard, recovery, schedule
from gpuschedule_tpu_torch.net import model as net
from gpuschedule_tpu_torch.policies import make_policy
from gpuschedule_tpu_torch.sim import Simulator
from gpuschedule_tpu_torch.sim.trace import generate_poisson_trace

# four v5e 4x4 pods: hosts, pods and uplinks for every fault scope
WORLD = ["--cluster", "tpu-v5e", "--dims", "4x4", "--pods", "4", "--synthetic", "150",
         "--seed", "42"]
# spec, extra flags, the counters that show the process fired
PROCESSES = {
    "mtbf": ("mtbf=86400,repair=3600,ckpt=1800", [], ("faults_mtbf", "fault_revocations")),
    "maintenance": ("maintenance=20000,maintenance_duration=3600", [],
                    ("faults_maintenance",)),
    "spot": ("spot=0.25,spot_mtbf=20000,spot_outage=3600,spot_warning=600,ckpt_write=auto", [],
             ("faults_spot", "spot_warnings")),
    "domain": ("domain_mtbf=20000,domain_repair=3600,domain_host=1,domain_pod=0.5", [],
               ("faults_domain",)),
    "hazard": ("mtbf=86400,hazard_shape=2,hazard_util=2,migrate_threshold=0.05", [],
               ("faults_mtbf", "proactive_migrates_blocked")),
    "straggler": ("straggler_mtbf=200000,straggler_repair=3600,straggler_degrade=0.5", [],
                  ("faults_straggler", "straggler_reprices")),
    "link": ("link_mtbf=20000,link_repair=3600,link_degrade=0.3", ["--net"],
             ("faults_link", "net_reprices")),
    "priced-ckpt": ("mtbf=86400,ckpt=900,ckpt_write=auto,restore=auto", [],
                    ("faults_mtbf", "fault_revocations")),
}


@pytest.mark.parametrize("policy", ["fifo", "dlas", "gandiva", "themis"])
@pytest.mark.parametrize("process", sorted(PROCESSES))
def test_fault_processes_equal_jax(process, policy, capsys, tmp_path):
    spec, extra, fired = PROCESSES[process]
    got = run_both(capsys, tmp_path, ["--policy", policy, *WORLD, "--faults", spec, *extra])
    assert got["num_finished"] == got["arrivals"] == 150.0
    c = counters(tmp_path)
    assert all(c.get(k, 0) > 0 for k in fired), {k: c.get(k) for k in fired}


@pytest.mark.parametrize("policy", ["fifo", "themis"])
def test_gpu_cluster_faults_equal_jax(policy, capsys, tmp_path):
    """Host and rack (switch) outages and straggler nodes on the GPU tree."""
    got = run_both(capsys, tmp_path, [
        "--policy", policy, "--cluster", "gpu", "--placement", "greedy", "--synthetic", "100",
        "--seed", "42", "--faults", "domain_mtbf=20000,domain_host=1,domain_rack=2,"
        "straggler_mtbf=100000,straggler_degrade=0.5"])
    assert got["num_finished"] == got["arrivals"] == 100.0
    c = counters(tmp_path)
    assert c["faults_domain"] > 0 and c["faults_straggler"] > 0


@pytest.mark.parametrize("spec", [None, "os=2,uplinks=2,partial=1"])
def test_net_equal_jax(spec, capsys, tmp_path):
    """The shared fabric over eight v5e 4x4 pods, the default spec and two
    sibling uplinks with the partial re-solve."""
    got = run_both(capsys, tmp_path, [
        "--cluster", "tpu-v5e", "--dims", "4x4", "--pods", "8", "--synthetic", "200",
        "--seed", "42", "--net", *([spec] if spec else [])])
    assert got["num_finished"] == 200 and counters(tmp_path)["net_reprices"] > 0


def _schedule(pkg_schedule, cluster, config_kw):
    config = pkg_schedule.FaultConfig(**config_kw)
    return [dataclasses.astuple(r) for r in pkg_schedule.generate_fault_schedule(
        cluster, config, horizon=200_000.0, seed=7)]


@pytest.mark.parametrize("world", ["v5e-4pods", "v5p-2pods", "gpu"])
def test_generated_schedules_equal_jax(world):
    """Every process at once, one schedule through each package."""
    make = {"v5e-4pods": (lambda: TpuCluster("v5e", dims=(4, 4), num_pods=4),
                          lambda: JaxTpu("v5e", dims=(4, 4), num_pods=4)),
            "v5p-2pods": (lambda: TpuCluster("v5p", num_pods=2), lambda: JaxTpu("v5p", num_pods=2)),
            "gpu": (lambda: GpuCluster(), lambda: JaxGpu())}[world]
    kw = dict(mtbf=50_000.0, maintenance_period=30_000.0, spot_fraction=0.25,
              spot_warning=300.0, domain_mtbf=40_000.0, straggler_mtbf=80_000.0,
              hazard_shape=1.5)
    if world != "gpu":
        kw.update(link_mtbf=30_000.0)
    ours, ref = _schedule(schedule, make[0](), kw), _schedule(jax_schedule, make[1](), kw)
    assert ours == ref and len({r[3] for r in ours}) >= 5


@pytest.mark.parametrize("with_plan", [False, True])
def test_inject_drain_equal_jax(with_plan):
    """A pod drained mid-replay, with no fault plan (a default one is armed)
    and on top of an MTBF plan; then the same drain in the past refuses."""
    out = []
    for sim_cls, cluster, pol, trace, sched, rec in (
            (JaxSimulator, JaxTpu, jax_make_policy, jax_trace, jax_schedule, jax_recovery),
            (Simulator, TpuCluster, make_policy, generate_poisson_trace, schedule, recovery)):
        c = cluster("v5e", dims=(4, 4), num_pods=4)
        plan = None
        if with_plan:
            plan = rec.make_fault_plan(c, sched.FaultConfig(mtbf=86_400.0),
                                       horizon=100_000.0, seed=3)
        sim = sim_cls(c, pol("dlas"), trace(150, seed=42), faults=plan)
        sim.run_until(4000.0)
        drain = sim.inject_drain(("pod", 1), duration=7200.0)
        assert (drain.time, drain.scope, drain.duration, drain.kind) == \
            (sim.now, ("pod", 1), 7200.0, "maintenance")
        with pytest.raises(ValueError, match="is in the past"):
            sim.inject_drain(("pod", 2), t=10.0)
        res = sim.run()
        out.append((res.summary(), dict(res.counters)))
    assert out[0] == out[1] and out[1][1]["faults_maintenance"] >= 1


BAD_FAULTS = ["nope=1", "mtbf", "straggler_degrade=2", "spot_warning=-1", "ckpt_write=-1",
              "hazard_shape=0", "hazard_util=-1", "migrate_threshold=0", "domain_host=-1",
              "link_degrade=1.5"]
BAD_NET = ["bogus=1", "os=0", "ingest=-1", "uplinks=1.5", "uplinks=9", "partial=2"]


@pytest.mark.parametrize("spec", BAD_FAULTS)
def test_fault_spec_errors_alike(spec):
    with pytest.raises(ValueError) as ref:
        jax_schedule.parse_fault_spec(spec)
    with pytest.raises(ValueError) as ours:
        schedule.parse_fault_spec(spec)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("spec", BAD_NET)
def test_net_spec_errors_alike(spec):
    with pytest.raises(ValueError) as ref:
        jax_net.parse_net_spec(spec)
    with pytest.raises(ValueError) as ours:
        net.parse_net_spec(spec)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("argv", [
    ["--faults", "nope=1"], ["--net", "os=0"],
    ["--dims", "4x4", "--faults", "domain_mtbf=1000,domain_rack=1"],  # a 4x4 pod has no racks
])
def test_cli_refusals_alike(argv, capsys):
    assert errors_alike(capsys, [*argv, "--synthetic", "5"])


def test_parsed_specs_equal_jax():
    spec = ",".join(spec for spec, _, _ in PROCESSES.values())
    (cfg, rec), (ref_cfg, ref_rec) = schedule.parse_fault_spec(spec), \
        jax_schedule.parse_fault_spec(spec)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert dataclasses.asdict(rec) == dataclasses.asdict(ref_rec)
    for spec in ("os=2,uplinks=2,partial=1", "ingest=0.1,oversubscription=1.5", ""):
        assert dataclasses.asdict(net.parse_net_spec(spec)) == \
            dataclasses.asdict(jax_net.parse_net_spec(spec))


def test_copied_tables_equal_the_originals():
    for ours, ref in ((schedule.FaultConfig, jax_schedule.FaultConfig),
                      (recovery.RecoveryModel, jax_recovery.RecoveryModel),
                      (hazard.HazardConfig, jax_hazard.HazardConfig),
                      (net.NetConfig, jax_net.NetConfig)):
        assert dataclasses.asdict(ours()) == dataclasses.asdict(ref()), ours.__name__
    assert schedule._SPEC_KEYS == jax_schedule._SPEC_KEYS
    assert net._SPEC_KEYS == jax_net._SPEC_KEYS
    assert hazard.hazard_config(schedule.FaultConfig()) is None
    assert math.isinf(schedule.FaultConfig().mtbf)


def test_chip_smoke_net_pin_is_the_jax_summary(tmp_path):
    """``chip_smoke.py`` holds the port's net replay to a summary line
    copied from the JAX package (it cannot import it): recompute that line
    here, so the pin stays tied to the reference."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    argv = [a.replace("{tmp}", str(tmp_path)) for a in chip_smoke.TOPOLOGY_RUNS["net"]]
    out = io.StringIO()
    with redirect_stdout(out):
        assert jax_cli.main(argv) == 0
    assert out.getvalue().strip() == chip_smoke.TOPOLOGY_PINS["net"]
    assert json.loads(chip_smoke.TOPOLOGY_PINS["net"])["net_reprices"] > 0
