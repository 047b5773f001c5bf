"""Attribution-layer smoke: the causal subsystem end to end at Philly
scale (the port's copy of the JAX package's ``tools/attrib_smoke.py``).

Runs a 200-job Philly-like replay with fault injection AND the shared-
fabric contention model on a 2-pod fleet (a deterministic slice of the
jobs promoted to multislice gangs, so the ``net-degraded`` leg is real),
with attribution and cluster sampling armed, then drives the whole
causal surface the way CI would:

1. the analyzer's wait/slowdown decomposition **closes bit-exactly**
   against ``SimResult.delay_by_cause`` (and the goodput closure still
   holds), with per-job residuals at float-dust level;
2. ``sample`` events yield a physical-occupancy series and mean;
3. `report` renders the stream into one self-contained HTML file with
   the attribution panel — asserted non-trivial and free of network
   references (same contract as ``tools.report_smoke``).

Run it (one JSON line, exit 1 on failure):

    python -m gpuschedule_tpu_torch.tools.attrib_smoke
"""

from __future__ import annotations

import json
import math
import sys
import tempfile
from pathlib import Path

from gpuschedule_tpu_torch.cli import main as cli_main
from gpuschedule_tpu_torch.cluster.tpu import TpuCluster
from gpuschedule_tpu_torch.faults.recovery import FaultPlan, RecoveryModel
from gpuschedule_tpu_torch.faults.schedule import (
    FaultConfig,
    fault_horizon,
    generate_fault_schedule,
)
from gpuschedule_tpu_torch.net import NetModel
from gpuschedule_tpu_torch.net.sweep import promote_to_multislice
from gpuschedule_tpu_torch.obs.analyze import analyze_file
from gpuschedule_tpu_torch.obs import config_hash
from gpuschedule_tpu_torch.policies import make_policy
from gpuschedule_tpu_torch.sim import Simulator
from gpuschedule_tpu_torch.sim.metrics import MetricsLog
from gpuschedule_tpu_torch.sim.philly import generate_philly_like_trace

NUM_JOBS = 200
SEED = 0
SAMPLE_INTERVAL_S = 900.0


def run_smoke(tmp_dir=None) -> dict:
    """Returns a result dict with ``ok`` plus the observations behind it;
    raises AssertionError on any contract violation."""
    tmp = Path(tmp_dir) if tmp_dir else Path(tempfile.mkdtemp(prefix="gstpu_attrib_"))
    events = tmp / "attrib.events.jsonl"

    cluster = TpuCluster("v5e", dims=(8, 8), num_pods=2)
    jobs = promote_to_multislice(
        generate_philly_like_trace(NUM_JOBS, seed=SEED),
        0.05, cluster.pod_chips, seed=SEED,
    )
    plan = FaultPlan(
        records=generate_fault_schedule(
            cluster, FaultConfig(mtbf=12 * 3600.0, repair=1800.0),
            horizon=fault_horizon(jobs), seed=SEED,
        ),
        recovery=RecoveryModel(ckpt_interval=900.0, restore=30.0),
    )
    chash = config_hash({"smoke": "attrib", "seed": SEED})
    metrics = MetricsLog(
        events_sink=events,
        run_meta={"run_id": f"attrib-s{SEED}-{chash}", "seed": SEED,
                  "policy": "dlas", "config_hash": chash},
        attribution=True,
    )
    with metrics:
        res = Simulator(
            cluster, make_policy("dlas"), jobs,
            metrics=metrics, faults=plan, net=NetModel(),
            sample_interval=SAMPLE_INTERVAL_S,
        ).run()

    an = analyze_file(events)

    # 1. the attribution closures: analyzer == engine to the last float
    assert an.delay_by_cause() == res.delay_by_cause, "delay closure broke"
    assert an.goodput() == res.goodput, "goodput closure broke"
    at = an.attribution()
    assert at["max_wait_residual"] < 1e-6, at["max_wait_residual"]
    assert at["max_jct_residual"] < 1e-6, at["max_jct_residual"]
    legs = an.delay_by_cause()
    assert "fault-outage" in legs, f"chaos run blamed no fault wait: {legs}"
    assert "net-degraded" in legs, f"netted run saw no contention leg: {legs}"

    # 2. cluster sampling reconstructed
    assert an.sample_series, "no sample events analyzed"
    assert an.mean_phys_occupancy is not None
    assert 0.0 < an.mean_phys_occupancy <= 1.0

    # 3. the report renders the attribution panel, network-free
    report = tmp / "attrib_report.html"
    rc = cli_main(["report", "--events", str(events), "--out", str(report)])
    assert rc == 0, f"report failed rc={rc}"
    doc = report.read_text()
    assert len(doc) > 10_000, "report suspiciously small"
    for pattern in ("http://", "https://", "<script", "<link", "src="):
        assert pattern not in doc, f"network/script reference {pattern!r}"
    assert "Attribution" in doc, "attribution panel missing"
    assert "physical" in doc, "physical-occupancy overlay missing"

    return {
        "ok": True,
        "report_bytes": len(doc),
        "events": sum(1 for _ in open(events)),
        "samples": len(an.sample_series),
        "mean_phys_occupancy": round(an.mean_phys_occupancy, 4),
        "delay_by_cause": {k: round(v, 3) for k, v in sorted(legs.items())},
        "max_wait_residual": at["max_wait_residual"],
        "max_jct_residual": at["max_jct_residual"],
        "tmp": str(tmp),
    }


if __name__ == "__main__":
    try:
        res = run_smoke()
    except AssertionError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        sys.exit(1)
    print(json.dumps(res, sort_keys=True))
    sys.exit(0)
