"""Analytics-layer smoke: report + compare end to end (the port's copy of
the JAX package's ``tools/report_smoke.py``).

Runs a 200-job Philly-like replay (with fault injection, so the fault
panel renders), captures the event stream, then drives the whole
analytics surface the way CI would:

1. `report` renders the stream into one self-contained HTML file —
   asserted non-trivial and free of network references;
2. a **self-compare** of the run against an identical re-run must exit 0
   (same seed => byte-identical stream => zero deltas);
3. a cross-policy compare at a hostile threshold (1e-12 relative) must
   exit **nonzero** — the CI-gate contract that regressions actually trip
   the gate.

Run it (one JSON line, exit 1 on failure):

    python -m gpuschedule_tpu_torch.tools.report_smoke
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

from gpuschedule_tpu_torch.cli import main as cli_main

NUM_JOBS = 200
SEED = 0


def _capture(tmp: Path, policy: str, name: str) -> Path:
    path = tmp / f"{name}.events.jsonl"
    rc = cli_main([
        "run", "--policy", policy, "--cluster", "tpu-v5e", "--dims", "8x8",
        "--synthetic", str(NUM_JOBS), "--seed", str(SEED),
        "--faults", "mtbf=43200,repair=1800,ckpt=900",
        "--events", str(path),
    ])
    assert rc == 0, f"run --policy {policy} failed with rc={rc}"
    return path


def run_smoke(tmp_dir=None) -> dict:
    """Returns a result dict with ``ok`` plus the observations behind it;
    raises AssertionError on any contract violation."""
    tmp = Path(tmp_dir) if tmp_dir else Path(tempfile.mkdtemp(prefix="gstpu_smoke_"))
    a = _capture(tmp, "dlas", "a")
    a_again = _capture(tmp, "dlas", "a_again")  # identical world, re-run
    b = _capture(tmp, "fifo", "b")              # same world, other policy

    # 1. the report renders, self-contained
    report = tmp / "report.html"
    rc = cli_main(["report", "--events", str(a), "--out", str(report),
                   "--json", str(tmp / "analysis.json")])
    assert rc == 0, f"report failed rc={rc}"
    doc = report.read_text()
    assert len(doc) > 10_000, "report suspiciously small"
    for pattern in ("http://", "https://", "<script", "<link", "src="):
        assert pattern not in doc, f"network/script reference {pattern!r}"
    assert "<h2>Faults</h2>" in doc, "fault panel missing from a chaos run"
    analysis = json.loads((tmp / "analysis.json").read_text())
    assert analysis["summary"]["num_jobs"] == NUM_JOBS

    # 2. identical runs compare clean (exit 0)
    rc_self = cli_main(["compare", str(a), str(a_again)])
    assert rc_self == 0, f"self-compare must exit 0, got {rc_self}"

    # 3. a tightened threshold trips the gate on a real difference
    rc_diff = cli_main(["compare", str(a), str(b), "--threshold", "1e-12"])
    assert rc_diff == 1, f"tightened compare must exit 1, got {rc_diff}"

    return {
        "ok": True,
        "report_bytes": len(doc),
        "events_a": sum(1 for _ in open(a)),
        "self_compare_rc": rc_self,
        "tightened_compare_rc": rc_diff,
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
