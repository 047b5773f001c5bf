"""Cross-run history store: an append-only sqlite ledger of run results.

The port's own copy of ``gpuschedule_tpu/obs/history.py``: one store
format, which either package's ``history`` reads.

Every analytics surface so far is *within-invocation*: ``run`` prints one
summary, ``compare`` diffs the streams it was handed, ``engine_bench``
prints one ladder — and the next invocation starts blind.  This store
gives results a memory: ``run --history PATH``, ``compare --history
PATH`` and the JAX package's ``tools/engine_bench.py --history PATH`` append each
invocation's summary (keyed by ``run_id`` / ``config_hash`` / a bench
``label``), and the ``history`` CLI subcommand renders per-metric
trajectories across invocations — the substrate the ROADMAP's TopoOpt
compare-matrix search loop needs (accumulate topology x policy cells
across sessions, then ask "what fabric should we buy?").

Properties:

- **append-only**: rows are never updated or deleted; ``seq`` (the sqlite
  rowid) is the invocation order;
- **deterministic reads**: ``trend``/``rows`` are pure functions of the
  store's contents — two CLI invocations over the same file render the
  same table (the insertion timestamp is stored but never breaks a tie;
  ``seq`` already totally orders rows);
- **schema-stable JSON payload**: arbitrary summary dicts ride a single
  ``metrics`` JSON column, so new summary keys never need a migration;
- pure stdlib, no sim imports (the obs-layer rule).
"""

from __future__ import annotations

import json
import math
import sqlite3
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence


@dataclass
class HistoryRow:
    """One appended invocation result."""

    seq: int
    ts: float
    kind: str            # "run" | "compare" | "bench" | caller-defined
    run_id: str
    config_hash: str
    policy: str
    seed: Optional[int]
    label: str           # free-form sub-key (bench: "plain/1000")
    metrics: Dict[str, object] = field(default_factory=dict)

    def metric(self, name: str) -> Optional[float]:
        v = self.metrics.get(name)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        return float(v)


class HistoryStore:
    """The sqlite-backed ledger.  Safe to open concurrently for appends
    (sqlite serializes writers); a missing file is created with the
    schema on first open."""

    def __init__(self, path):
        self.path = Path(path)
        if self.path.parent and not self.path.parent.exists():
            self.path.parent.mkdir(parents=True, exist_ok=True)
        self._db = sqlite3.connect(str(self.path))
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS runs ("
            "seq INTEGER PRIMARY KEY AUTOINCREMENT,"
            "ts REAL NOT NULL,"
            "kind TEXT NOT NULL,"
            "run_id TEXT NOT NULL DEFAULT '',"
            "config_hash TEXT NOT NULL DEFAULT '',"
            "policy TEXT NOT NULL DEFAULT '',"
            "seed INTEGER,"
            "label TEXT NOT NULL DEFAULT '',"
            "metrics TEXT NOT NULL)"
        )
        self._db.execute(
            "CREATE INDEX IF NOT EXISTS runs_key "
            "ON runs (kind, config_hash, label)"
        )
        self._db.commit()

    # ------------------------------------------------------------------ #

    def append(
        self,
        kind: str,
        *,
        metrics: Dict[str, object],
        run_id: str = "",
        config_hash: str = "",
        policy: str = "",
        seed: Optional[int] = None,
        label: str = "",
        ts: Optional[float] = None,
    ) -> int:
        """Append one invocation result; returns its ``seq``.  Non-finite
        floats are stored as strings ("inf"/"nan") so the payload stays
        strict JSON — the same rule the sweep artifacts follow."""
        cur = self._db.execute(
            "INSERT INTO runs (ts, kind, run_id, config_hash, policy, seed,"
            " label, metrics) VALUES (?,?,?,?,?,?,?,?)",
            (
                float(ts if ts is not None else time.time()),
                str(kind), str(run_id), str(config_hash), str(policy),
                None if seed is None else int(seed), str(label),
                json.dumps(_jsonable(metrics), sort_keys=True),
            ),
        )
        self._db.commit()
        return int(cur.lastrowid)

    def rows(
        self,
        *,
        kind: Optional[str] = None,
        config_hash: Optional[str] = None,
        run_id: Optional[str] = None,
        label: Optional[str] = None,
        last: Optional[int] = None,
    ) -> List[HistoryRow]:
        """Matching rows in ``seq`` (invocation) order; ``last`` keeps
        only the newest N."""
        clauses, params = [], []
        for col, val in (
            ("kind", kind), ("config_hash", config_hash),
            ("run_id", run_id), ("label", label),
        ):
            if val is not None:
                clauses.append(f"{col} = ?")
                params.append(val)
        where = (" WHERE " + " AND ".join(clauses)) if clauses else ""
        sql = (
            "SELECT seq, ts, kind, run_id, config_hash, policy, seed, "
            f"label, metrics FROM runs{where} ORDER BY seq"
        )
        out = [
            HistoryRow(
                seq=int(r[0]), ts=float(r[1]), kind=r[2], run_id=r[3],
                config_hash=r[4], policy=r[5],
                seed=None if r[6] is None else int(r[6]),
                label=r[7], metrics=json.loads(r[8]),
            )
            for r in self._db.execute(sql, params)
        ]
        if last is not None and last >= 0:
            out = out[-last:] if last > 0 else []
        return out

    def count(
        self,
        *,
        kind: Optional[str] = None,
        config_hash: Optional[str] = None,
        run_id: Optional[str] = None,
        label: Optional[str] = None,
    ) -> int:
        """Matching-row count without materializing the rows — how the
        watchtower's incident drill proves its alert counter and this
        ledger agree."""
        clauses, params = [], []
        for col, val in (
            ("kind", kind), ("config_hash", config_hash),
            ("run_id", run_id), ("label", label),
        ):
            if val is not None:
                clauses.append(f"{col} = ?")
                params.append(val)
        where = (" WHERE " + " AND ".join(clauses)) if clauses else ""
        (n,) = self._db.execute(
            f"SELECT COUNT(*) FROM runs{where}", params
        ).fetchone()
        return int(n)

    def close(self) -> None:
        self._db.close()

    def __enter__(self) -> "HistoryStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _jsonable(obj):
    """Strict-JSON coercion (inf/nan -> strings), recursively."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)  # "inf" / "-inf" / "nan"
    return obj


# --------------------------------------------------------------------- #
# trend rendering


def trend_points(
    rows: Sequence[HistoryRow], metric: str
) -> List[HistoryRow]:
    """The rows that actually carry ``metric`` as a number, in order."""
    return [r for r in rows if r.metric(metric) is not None]


def trend_delta(
    rows: Sequence[HistoryRow], metric: str, *, last: int = 5
) -> Optional[dict]:
    """The newest row's value against the median of up to ``last`` prior
    rows — how engine_bench turns one suspect number on a 2x-noise box
    into a position within a distribution.  None when there is no prior
    history (first invocation) or no carrying row at all."""
    pts = trend_points(rows, metric)
    if not pts or last <= 0:
        return None
    cur = pts[-1]
    prior = [r.metric(metric) for r in pts[:-1]][-last:]
    if not prior:
        return None
    s = sorted(prior)
    n = len(s)
    med = s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0
    value = cur.metric(metric)
    return {
        "metric": metric,
        "value": value,
        "median": med,
        "n_prior": len(prior),
        "delta": (value - med),
        "delta_frac": ((value - med) / med) if med else None,
    }


def render_trend(
    rows: Sequence[HistoryRow], metrics: Sequence[str]
) -> str:
    """Fixed-width per-metric trajectory table over ``rows`` (invocation
    order).  Deterministic: a pure function of the rows — two separate
    CLI invocations over the same store print identical bytes."""
    if not rows:
        return "(empty history)"
    headers = ["seq", "kind", "policy", "label", "run"] + [
        f"{m}" for m in metrics
    ] + [f"d%({m})" for m in metrics]
    table: List[List[str]] = [headers]
    prev: Dict[str, Optional[float]] = {m: None for m in metrics}
    for r in rows:
        cells = [
            str(r.seq), r.kind, r.policy or "-", r.label or "-",
            (r.run_id[:24] or "-"),
        ]
        deltas = []
        for m in metrics:
            v = r.metric(m)
            cells.append(_fmt(v))
            p = prev[m]
            if v is None or p is None or p == 0:
                deltas.append("-")
            else:
                deltas.append(f"{100.0 * (v - p) / abs(p):+.1f}")
            if v is not None:
                prev[m] = v
        table.append(cells + deltas)
    widths = [max(len(row[i]) for row in table) for i in range(len(headers))]
    lines = []
    for i, row in enumerate(table):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.6g}"
