"""Result analysis: JCT CDFs, policy/topology comparison reports.

The port's own copy of ``gpuschedule_tpu/analysis.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_topology.py`` holds its results equal
to the original's, to the bit.

The reference ships Jupyter notebooks that run experiment grids and plot
JCT CDFs / makespan bars (SURVEY.md §2 "Notebooks", §3.4).  This module is
the library form of those notebooks — pure functions over SimResults that
the CLI's ``compare`` / ``report`` commands and any notebook can call;
outputs are plain dict/CSV so pandas/matplotlib consumption is one line.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from gpuschedule_tpu_torch.sim.metrics import SimResult


def jct_cdf(result: SimResult, *, points: int = 100) -> List[Tuple[float, float]]:
    """(jct_seconds, cumulative_fraction) pairs — the notebook headline plot."""
    jcts = sorted(j.jct() for j in result.jobs if j.jct() is not None and j.state.value != "rejected")
    if not jcts:
        return []
    n = len(jcts)
    step = max(1, n // points)
    out = [(jcts[i], (i + 1) / n) for i in range(0, n, step)]
    # ensure the curve reaches 1.0 even when the max JCT value is tied with
    # the last sampled point (comparing values instead of fractions here
    # used to leave the CDF topping out below 1)
    if out[-1][1] != 1.0:
        if out[-1][0] == jcts[-1]:
            out[-1] = (jcts[-1], 1.0)
        else:
            out.append((jcts[-1], 1.0))
    return out


def summarize(results: Dict[str, SimResult]) -> Dict[str, dict]:
    """name -> headline metrics, for grid experiments."""
    return {name: res.summary() for name, res in results.items()}


ACCEPTANCE_THRESHOLD_PCT = 5.0  # fixed by the BASELINE.json:5 contract


def scale_offered_load(jobs, factor: float):
    """Rescale a trace's offered load in place by stretching arrivals.

    ``factor`` < 1 lowers the load (inter-arrival gaps divide by it); job
    sizes and durations are untouched, so only queueing pressure changes.
    Returns the same list for chaining.
    """
    if factor <= 0:
        raise ValueError(f"load factor must be positive, got {factor}")
    for j in jobs:
        j.submit_time = j.submit_time / factor
    return jobs


def acceptance_load_sweep(
    make_jobs,
    baseline_factory,
    candidate_factory,
    policy_factory,
    *,
    loads: Sequence[float] = (0.70, 0.80, 0.90, 0.95),
    base_load: float = 0.95,
    base_results=None,
) -> Dict[str, dict]:
    """The acceptance band as a function of offered load.

    The curve behind the plain-FIFO pin: at the published arrival rate the 10k replay runs
    ~95% offered load, where HOL queueing explodes any capacity the pow2
    round-up forfeits; sweeping the load shows where the policy re-enters
    the band — and catches a future allocator regression that a single
    already-huge delta would hide.  Each entry replays baseline and
    candidate clusters on the same load-rescaled trace.
    """
    from gpuschedule_tpu_torch.sim.engine import Simulator

    out: Dict[str, dict] = {}
    for load in loads:
        if base_results is not None and abs(load - base_load) < 1e-12:
            # the caller already replayed the unscaled trace: reuse
            out[f"{load:.2f}"] = acceptance_band(*base_results)
            continue
        factor = load / base_load
        base = Simulator(
            baseline_factory(), policy_factory(),
            scale_offered_load(make_jobs(), factor),
        ).run()
        cand = Simulator(
            candidate_factory(), policy_factory(),
            scale_offered_load(make_jobs(), factor),
        ).run()
        out[f"{load:.2f}"] = acceptance_band(base, cand)
    return out


def acceptance_band(baseline: SimResult, candidate: SimResult) -> dict:
    """The BASELINE.json:5 contract, computed: is the TPU replay's avg-JCT
    and makespan within 5% of the GPU-backed baseline?

    Deltas are signed percentages relative to the baseline (negative =
    candidate better).  "Within" is one-sided: a candidate that *beats* the
    baseline by more than the threshold still satisfies the contract — the
    band bounds regression, not improvement.  A delta is ``None`` (and the
    verdict False) when the baseline metric is zero with a nonzero
    candidate — undefined rather than infinite, so the dict stays strict
    JSON.
    """
    b, c = baseline.summary(), candidate.summary()

    def delta(key: str):
        if b[key] == 0:
            return 0.0 if c[key] == 0 else None
        return 100.0 * (c[key] - b[key]) / b[key]

    jct = delta("avg_jct")
    mk = delta("makespan")
    t = ACCEPTANCE_THRESHOLD_PCT
    return {
        "jct_delta_pct": jct,
        "makespan_delta_pct": mk,
        "threshold_pct": t,
        "within_5pct": jct is not None and mk is not None and jct <= t and mk <= t,
    }


def write_report(
    results: Dict[str, SimResult],
    out_dir: str | Path,
    *,
    prefix: str = "",
    extra: Optional[dict] = None,
) -> None:
    """Persist a comparison: summary JSON + per-config JCT CDF CSVs +
    a markdown table (the notebook's bar-chart data in text form).

    ``extra`` entries (e.g. the :func:`acceptance_band` verdict) are merged
    into the summary JSON under their own keys and appended to the report.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    summary = summarize(results)
    payload = dict(summary)
    if extra:
        overlap = set(extra) & set(payload)
        if overlap:
            raise ValueError(f"extra keys collide with config names: {sorted(overlap)}")
        payload.update(extra)
    with open(out / f"{prefix}summary.json", "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    for name, res in results.items():
        with open(out / f"{prefix}cdf_{name}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["jct_seconds", "cum_fraction"])
            w.writerows(jct_cdf(res))
    lines = [
        "| config | avg JCT (s) | makespan (s) | p95 queue (s) | "
        "p95 slowdown | util | finished | rejected |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for name in sorted(results):
        s = summary[name]
        lines.append(
            f"| {name} | {s['avg_jct']:.1f} | {s['makespan']:.1f} | "
            f"{s['p95_queueing_delay']:.1f} | "
            f"{s['p95_slowdown']:.2f} | "
            f"{s['mean_utilization']:.3f} | "
            f"{int(s['num_finished'])} | {int(s.get('num_rejected', 0))} |"
        )
    if extra and "acceptance" in extra:
        a = extra["acceptance"]

        def fmt(d):
            return "undefined (zero baseline)" if d is None else f"{d:+.2f}%"

        lines += [
            "",
            f"**Acceptance (BASELINE.json:5, ±{a['threshold_pct']:g}% band):** "
            f"avg-JCT delta {fmt(a['jct_delta_pct'])}, "
            f"makespan delta {fmt(a['makespan_delta_pct'])} vs the GPU-backed "
            f"baseline → {'WITHIN' if a['within_5pct'] else 'OUTSIDE'} the band.",
        ]
    (out / f"{prefix}report.md").write_text("\n".join(lines) + "\n")
