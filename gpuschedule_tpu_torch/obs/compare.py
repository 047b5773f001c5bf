"""Cross-run regression diff over two analyzed event streams.

The port's own copy of ``gpuschedule_tpu/obs/compare.py``.

Answers "did my change regress the scheduler?" the way CI wants it
answered: metric by metric, with polarity-aware relative thresholds and an
exit code — 0 when run B is within threshold of run A everywhere, nonzero
past any threshold, refusal (``SchemaError``) when the two streams are not
comparable in the first place.

Comparability is the header contract (obs/analyze.py): both streams must
carry a schema-1 header, and their ``seed`` and ``config_hash`` must match
— the config hash covers cluster + trace + fault spec but *not* the
policy, so the two intended uses both work out of the box:

- **policy A vs policy B** on the same seeded world (headers match,
  ``policy`` differs and is reported);
- **pre-change vs post-change** at the same seed (everything matches).

Comparing runs of *different worlds* is almost always a mistake (the
deltas measure the worlds, not the scheduler) and is refused unless
``allow_mismatch=True`` / ``--allow-mismatch``.

Only metrics in :data:`GATED_METRICS` can fail the gate; everything else
in the summary is reported as informational.  Polarity matters: avg JCT
going *up* is a regression, mean occupancy going *down* is.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from gpuschedule_tpu_torch.obs.analyze import RunAnalysis, SchemaError

# Gate-able metrics and their polarity: +1 means "bigger is worse" (a
# bigger B regresses), -1 means "smaller is worse".  Metrics absent here
# are informational — reported, never gating (preemption counts, say, are
# a policy's mechanism, not its quality).
GATED_METRICS: Dict[str, int] = {
    "avg_jct": +1,
    "makespan": +1,
    "wait_p50": +1,
    "wait_p95": +1,
    "wait_p99": +1,
    "jct_p50": +1,
    "jct_p95": +1,
    "jct_p99": +1,
    "slowdown_p95": +1,
    "goodput_lost_chip_s": +1,
    "goodput_restart_overhead_chip_s": +1,
    "num_finished": -1,
    "mean_occupancy": -1,
    "useful_frac": -1,
}

DEFAULT_THRESHOLD = 0.05  # 5% relative worsening

# deltas below this absolute size never gate: float dust on near-zero
# baselines (a lost_chip_s of 1e-9 vs 0.0) is not a regression signal
ABS_FLOOR = 1e-9


def flatten_metrics(analysis: RunAnalysis) -> Dict[str, Optional[float]]:
    """One flat {metric: value} view of an analysis: the summary scalars
    plus the distribution quantiles under ``<dist>_<quantile>`` keys."""
    out: Dict[str, Optional[float]] = {}
    for k, v in analysis.summary().items():
        out[k] = float(v) if isinstance(v, (int, float)) else None
    for dist, block in analysis.distributions().items():
        for q in ("p50", "p95", "p99", "mean"):
            v = block.get(q)
            out[f"{dist}_{q}"] = float(v) if v is not None else None
    return out


@dataclass
class MetricDiff:
    metric: str
    a: Optional[float]
    b: Optional[float]
    delta: Optional[float]        # b - a
    rel: Optional[float]          # (b - a) / |a|; None when undefined
    gated: bool
    threshold: Optional[float]    # the threshold applied (gated rows only)
    regressed: bool

    def to_json(self) -> dict:
        return {
            "metric": self.metric, "a": self.a, "b": self.b,
            "delta": self.delta, "rel": self.rel, "gated": self.gated,
            "threshold": self.threshold, "regressed": self.regressed,
        }


@dataclass
class CompareResult:
    run_a: dict                   # header summaries for the report/CLI
    run_b: dict
    rows: List[MetricDiff] = field(default_factory=list)

    @property
    def regressions(self) -> List[MetricDiff]:
        return [r for r in self.rows if r.regressed]

    @property
    def ok(self) -> bool:
        return not self.regressions

    @property
    def exit_code(self) -> int:
        """The CI contract: 0 identical-or-within-threshold, 1 regressed."""
        return 0 if self.ok else 1

    def to_json(self) -> dict:
        return {
            "run_a": self.run_a,
            "run_b": self.run_b,
            "ok": self.ok,
            "regressions": [r.metric for r in self.regressions],
            "rows": [r.to_json() for r in self.rows],
        }

    def format_table(self) -> str:
        """Human-readable diff, regressions first, informational rows after."""

        def fmt(v: Optional[float]) -> str:
            if v is None:
                return "-"
            if v != v:  # nan
                return "nan"
            return f"{v:.6g}"

        lines = [
            f"A: {_ident(self.run_a)}",
            f"B: {_ident(self.run_b)}",
            f"{'metric':32s} {'A':>12s} {'B':>12s} {'delta':>12s} "
            f"{'rel':>8s}  verdict",
        ]
        ordered = sorted(
            self.rows, key=lambda r: (not r.regressed, not r.gated, r.metric)
        )
        for r in ordered:
            rel = "-" if r.rel is None else f"{r.rel:+.2%}"
            verdict = (
                "REGRESSED" if r.regressed
                else ("ok" if r.gated else "info")
            )
            lines.append(
                f"{r.metric:32s} {fmt(r.a):>12s} {fmt(r.b):>12s} "
                f"{fmt(r.delta):>12s} {rel:>8s}  {verdict}"
            )
        lines.append(
            f"=> {'OK' if self.ok else 'REGRESSED'} "
            f"({len(self.regressions)} of {sum(1 for r in self.rows if r.gated)} "
            f"gated metrics past threshold)"
        )
        return "\n".join(lines)


def _ident(meta: dict) -> str:
    return (
        f"policy={meta.get('policy') or '?'} seed={meta.get('seed')} "
        f"config={meta.get('config_hash') or '?'} run_id={meta.get('run_id') or '?'}"
    )


def check_comparable(
    a: RunAnalysis, b: RunAnalysis, *, allow_mismatch: bool = False
) -> None:
    """Refuse un-comparable stream pairs (missing headers, different
    schema, different seeded world) instead of diffing garbage."""
    for name, an in (("A", a), ("B", b)):
        if an.header is None:
            raise SchemaError(
                f"run {name} has no stream header; capture it with run "
                f"identity (CLI --events) — refusing to compare"
            )
    if allow_mismatch:
        return
    ha, hb = a.header, b.header
    mismatched = [
        k for k, va, vb in (
            ("seed", ha.seed, hb.seed),
            ("config_hash", ha.config_hash, hb.config_hash),
        )
        if va != vb
    ]
    if mismatched:
        raise SchemaError(
            "runs are not comparable: "
            + ", ".join(
                f"{k} {getattr(ha, k)!r} != {getattr(hb, k)!r}"
                for k in mismatched
            )
            + " — the deltas would measure different worlds, not the "
            "scheduler (pass --allow-mismatch to override)"
        )


def compare_runs(
    a: RunAnalysis,
    b: RunAnalysis,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    per_metric: Optional[Dict[str, float]] = None,
    allow_mismatch: bool = False,
) -> CompareResult:
    """Diff run B against baseline run A metric by metric.

    ``threshold`` is the default relative-worsening gate; ``per_metric``
    overrides it for individual metrics (``{"wait_p99": 0.01}``).  A
    negative threshold demands *improvement* — handy for asserting a
    change helped, and for forcing a nonzero exit in smoke tests.
    """
    check_comparable(a, b, allow_mismatch=allow_mismatch)
    per_metric = per_metric or {}
    ma, mb = flatten_metrics(a), flatten_metrics(b)
    rows: List[MetricDiff] = []
    for metric in sorted(set(ma) | set(mb)):
        va, vb = ma.get(metric), mb.get(metric)
        polarity = GATED_METRICS.get(metric)
        gated = polarity is not None
        thr = per_metric.get(metric, threshold) if gated else None
        if va is None or vb is None or va != va or vb != vb:
            rows.append(MetricDiff(metric, va, vb, None, None, gated, thr, False))
            continue
        delta = vb - va
        rel = (delta / abs(va)) if va != 0.0 else (
            0.0 if delta == 0.0 else math.copysign(math.inf, delta)
        )
        regressed = False
        if gated:
            worsening = rel * polarity  # >0 means B is worse than A
            # ABS_FLOOR only suppresses float dust for ordinary positive
            # thresholds; a negative threshold *demands improvement*, so an
            # unchanged metric (delta == 0) must fail it
            regressed = worsening > thr and (thr < 0 or abs(delta) > ABS_FLOOR)
        rows.append(MetricDiff(metric, va, vb, delta, rel, gated, thr, regressed))
    return CompareResult(
        run_a=a.header.to_json() if a.header else {},
        run_b=b.header.to_json() if b.header else {},
        rows=rows,
    )


@dataclass
class MatrixResult:
    """An n-way policy x metric comparison.

    Unlike the two-run gate, the matrix ranks: for every gated metric the
    best and worst run are marked (polarity-aware — best avg_jct is the
    smallest, best num_finished the largest).  Informational metrics are
    listed unranked.  There is no pass/fail here; gating stays the
    two-run form's job, so its exit-code contract is untouched."""

    runs: List[dict]                       # header summaries, column order
    labels: List[str]                      # unique column labels
    metrics: Dict[str, List[Optional[float]]] = field(default_factory=dict)
    best: Dict[str, Optional[int]] = field(default_factory=dict)
    worst: Dict[str, Optional[int]] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "runs": self.runs,
            "labels": self.labels,
            "metrics": {
                m: {
                    "values": vals,
                    "best": self.best.get(m),
                    "worst": self.worst.get(m),
                    "gated": m in GATED_METRICS,
                }
                for m, vals in self.metrics.items()
            },
        }

    def format_table(self) -> str:
        """Text matrix, one column per run: gated metrics first, best
        value marked ``*`` and worst ``!`` (never color- or
        position-only; the legend line spells it out)."""

        def fmt(v: Optional[float]) -> str:
            if v is None:
                return "-"
            if v != v:
                return "nan"
            return f"{v:.6g}"

        # 14 fits "-1.23457e+06" plus the best/worst mark and a gap
        width = max(14, max((len(l) for l in self.labels), default=12) + 2)
        lines = [
            f"{len(self.labels)}-way compare (* best, ! worst per gated metric)"
        ]
        for i, (label, run) in enumerate(zip(self.labels, self.runs)):
            lines.append(f"  col {i + 1}: {label} — {_ident(run)}")
        lines.append(
            "metric".ljust(32)
            + "".join(label.rjust(width) for label in self.labels)
        )
        ordered = sorted(
            self.metrics, key=lambda m: (m not in GATED_METRICS, m)
        )
        for m in ordered:
            cells = []
            for i, v in enumerate(self.metrics[m]):
                mark = (
                    "*" if self.best.get(m) == i
                    else ("!" if self.worst.get(m) == i else " ")
                )
                cells.append(f"{fmt(v)}{mark}".rjust(width))
            lines.append(m.ljust(32) + "".join(cells))
        return "\n".join(lines)


def _unique_labels(analyses: Sequence[RunAnalysis]) -> List[str]:
    """Column labels: the policy name, disambiguated with the run_id when
    two runs share one (pre-vs-post runs of the same policy), and with
    the column index when even the run_ids collide (run_id is
    deterministic, so same-policy same-world captures all share it)."""
    policies = [
        (a.header.policy or f"run{i + 1}") if a.header else f"run{i + 1}"
        for i, a in enumerate(analyses)
    ]
    labels = []
    for i, p in enumerate(policies):
        if policies.count(p) > 1:
            rid = analyses[i].header.run_id if analyses[i].header else ""
            labels.append(f"{p}#{i + 1}" if not rid else f"{p}@{rid[-6:]}")
        else:
            labels.append(p)
    dupes = {label for label in labels if labels.count(label) > 1}
    return [
        f"{label}#{i + 1}" if label in dupes else label
        for i, label in enumerate(labels)
    ]


def compare_matrix(
    analyses: Sequence[RunAnalysis], *, allow_mismatch: bool = False
) -> MatrixResult:
    """Build the n-way policy x metric matrix over ``analyses`` (>= 2).

    Every run must be comparable with the first — same seeded world
    (seed + config_hash), the exact rule the two-run gate applies —
    unless ``allow_mismatch``.  Best/worst are only awarded on gated
    metrics where at least two values exist and they actually differ
    (an all-equal row has no winner)."""
    analyses = list(analyses)
    if len(analyses) < 2:
        raise ValueError("compare_matrix needs at least two runs")
    for other in analyses[1:]:
        check_comparable(analyses[0], other, allow_mismatch=allow_mismatch)
    flats = [flatten_metrics(a) for a in analyses]
    names = sorted(set().union(*flats))
    metrics: Dict[str, List[Optional[float]]] = {}
    best: Dict[str, Optional[int]] = {}
    worst: Dict[str, Optional[int]] = {}
    for m in names:
        vals = [f.get(m) for f in flats]
        metrics[m] = vals
        polarity = GATED_METRICS.get(m)
        best[m] = worst[m] = None
        if polarity is None:
            continue
        present = [(v, i) for i, v in enumerate(vals)
                   if v is not None and v == v]
        if len(present) < 2 or all(v == present[0][0] for v, _ in present):
            continue
        # polarity +1: bigger is worse -> best is the minimum
        ranked = sorted(present, key=lambda p: (polarity * p[0], p[1]))
        best[m], worst[m] = ranked[0][1], ranked[-1][1]
    return MatrixResult(
        runs=[a.header.to_json() if a.header else {} for a in analyses],
        labels=_unique_labels(analyses),
        metrics=metrics,
        best=best,
        worst=worst,
    )


def write_matrix_json(result: MatrixResult, path) -> None:
    with open(path, "w") as f:
        json.dump(result.to_json(), f, indent=2, sort_keys=True)


def parse_thresholds(specs) -> tuple:
    """CLI ``--threshold`` values: a bare float sets the default gate, a
    ``metric=float`` pair overrides one metric; repeatable.  Returns
    ``(default, per_metric)``."""
    default = DEFAULT_THRESHOLD
    per_metric: Dict[str, float] = {}
    for spec in specs or []:
        k, sep, v = str(spec).partition("=")
        try:
            if sep:
                per_metric[k] = float(v)
            else:
                default = float(k)
        except ValueError:
            raise ValueError(
                f"--threshold wants FLOAT or METRIC=FLOAT, got {spec!r}"
            ) from None
    unknown = sorted(set(per_metric) - set(GATED_METRICS))
    if unknown:
        raise ValueError(
            f"--threshold for non-gated metrics {unknown}; gated metrics: "
            f"{sorted(GATED_METRICS)}"
        )
    return default, per_metric


def write_compare_json(result: CompareResult, path) -> None:
    with open(path, "w") as f:
        json.dump(result.to_json(), f, indent=2, sort_keys=True)
