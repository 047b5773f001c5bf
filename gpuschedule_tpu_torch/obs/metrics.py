"""Metrics registry: labeled counters/gauges/histograms, Prometheus + JSON.

The port's own copy of ``gpuschedule_tpu/obs/metrics.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_sim*.py`` hold its replays equal
to the original's, to the bit.

The aggregation half of the observability layer: where
:class:`~gpuschedule_tpu_torch.sim.metrics.MetricsLog` is a per-run recorder (CSV
rows, event stream), this registry is a process-level surface in the
Prometheus data model — monotone counters, point-in-time gauges, and
bucketed histograms, each optionally labeled — with two exports:

- :meth:`MetricsRegistry.prometheus_text`: the text exposition format, the
  thing a scrape endpoint would serve (``# HELP`` / ``# TYPE`` / samples);
- :meth:`MetricsRegistry.to_json`: the same state as one JSON document for
  artifact files next to the run's CSVs.

``MetricsLog`` absorbs this registry when constructed with one: its
``counters`` keep working exactly as before (the BASELINE summary contract),
and every ``count()``/``sample()`` additionally feeds the registry, which is
how a replay's counters reach the Prometheus surface without a second
bookkeeping path.

Zero dependencies, thread-safe (one lock per metric family), and dormant
unless something asks for a registry — nothing global is updated during an
un-instrumented run.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# The Prometheus text exposition content type (format version 0.0.4) —
# what a conforming /metrics endpoint declares.
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Prometheus' default histogram buckets, trimmed to the second-to-minutes
# range scheduling telemetry actually spans.
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0, 600.0, math.inf
)

# Millisecond-scale buckets for interactive-query latency (the what-if
# service's per-query histogram): sub-ms through tens of
# seconds, dense around the 100-500 ms budget the digital twin serves in.
LATENCY_BUCKETS_MS = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 350.0, 500.0, 750.0,
    1000.0, 2000.0, 5000.0, 10_000.0, 30_000.0, math.inf
)

_VALID_FIRST = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_:")
_VALID_REST = _VALID_FIRST | set("0123456789")


def quantile_sorted(s: Sequence[float], q: float) -> float:
    """:func:`exact_quantile` on an ALREADY-SORTED sequence — the one-sort-
    many-quantiles path (the analyzer pulls p50/p95/p99 from each metric's
    single sorted copy instead of re-sorting per quantile)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile wants q in [0, 1], got {q}")
    if not s:
        raise ValueError("quantile of empty data")
    h = (len(s) - 1) * q
    i = int(math.floor(h))
    g = h - i
    if g == 0.0 or i + 1 >= len(s):
        return float(s[i])
    a, b = float(s[i]), float(s[i + 1])
    # numpy _lerp: anchor at b for g >= 0.5 (same rounding, hence bit-equal)
    if g >= 0.5:
        return b - (b - a) * (1.0 - g)
    return a + (b - a) * g


def exact_quantile(values: Sequence[float], q: float) -> float:
    """Exact quantile of raw observations, matching ``numpy.quantile``'s
    default "linear" method bit-for-bit: with ``n`` sorted values the target
    rank is ``h = (n-1)q``; the result interpolates between the two
    straddling order statistics using numpy's own lerp formulation (which
    switches anchor at ``g >= 0.5`` to keep the interpolation monotone), so
    the analyzer's p50/p95/p99 agree with a pandas/numpy cross-check to the
    last float."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile wants q in [0, 1], got {q}")
    return quantile_sorted(sorted(float(v) for v in values), q)


def sanitize_name(name: str) -> str:
    """Coerce an arbitrary key into a legal Prometheus metric name."""
    out = "".join(c if c in _VALID_REST else "_" for c in name)
    if not out or out[0] not in _VALID_FIRST:
        out = "_" + out
    return out


def _fmt_labels(labelnames: Sequence[str], labelvalues: Sequence[str]) -> str:
    if not labelnames:
        return ""
    inner = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in zip(labelnames, labelvalues)
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class _Metric:
    """One metric family: a name, help text, label schema, and its children
    (one child per distinct label-value tuple; the unlabeled family is its
    own single child keyed by ``()``)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        self.name = sanitize_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}
        self._lock = threading.Lock()
        self._labelvalues: Tuple[str, ...] = ()

    def labels(self, *values, **kv) -> "_Metric":
        """The child for one label-value combination (created on first use)."""
        if kv:
            if values:
                raise ValueError("pass label values positionally or by name, not both")
            try:
                values = tuple(str(kv[k]) for k in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e} for {self.name}") from None
            if set(kv) - set(self.labelnames):
                raise ValueError(
                    f"unknown labels {sorted(set(kv) - set(self.labelnames))} "
                    f"for {self.name}"
                )
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got {values}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child()
                child._labelvalues = values
                self._children[values] = child
            return child

    def _make_child(self) -> "_Metric":
        return type(self)(self.name, self.help, ())

    def _self_or_children(self) -> Iterable["_Metric"]:
        if self.labelnames:
            with self._lock:
                return list(self._children.values())
        return [self]

    def _check_unlabeled(self) -> None:
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; call .labels(...) first"
            )

    # exposition hooks ---------------------------------------------------
    def samples(self) -> List[Tuple[str, Tuple[Tuple[str, ...], ...], float]]:
        raise NotImplementedError

    def to_json(self):
        raise NotImplementedError

    # federation hooks ----------------------------------------
    def _payload(self):
        """This child's state as a picklable value (see
        :meth:`MetricsRegistry.snapshot`)."""
        raise NotImplementedError

    def _merge_payload(self, payload) -> None:
        """Fold one snapshot payload into this child."""
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self._check_unlabeled()
        if n < 0:
            raise ValueError(f"counters only go up; inc({n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def labeled_values(self) -> Dict[Tuple[str, ...], float]:
        """Per-child values keyed by label-value tuple (the unlabeled
        family reads as ``{(): value}``) — the read-back surface the
        watchtower uses to prove its ``watch_alerts_total{detector}``
        family and the history ledger agree alert for alert."""
        if not self.labelnames:
            return {(): self._value}
        with self._lock:
            return {lv: c._value for lv, c in self._children.items()}

    def samples(self):
        return [
            (self.name, c._labelvalues, c._value) for c in self._self_or_children()
        ]

    def to_json(self):
        if not self.labelnames:
            return self._value
        return {
            _fmt_labels(self.labelnames, lv) or "": c._value
            for lv, c in self._children.items()
        }

    def _payload(self):
        return self._value

    def _merge_payload(self, payload) -> None:
        self.inc(float(payload))


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def set(self, v: float) -> None:
        self._check_unlabeled()
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self._check_unlabeled()
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def samples(self):
        return [
            (self.name, c._labelvalues, c._value) for c in self._self_or_children()
        ]

    def to_json(self):
        if not self.labelnames:
            return self._value
        return {
            _fmt_labels(self.labelnames, lv) or "": c._value
            for lv, c in self._children.items()
        }

    def _payload(self):
        return self._value

    def _merge_payload(self, payload) -> None:
        # gauges are point-in-time readings: a merge keeps the incoming
        # value (last writer wins, in the caller's deterministic order)
        self.set(float(payload))


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bs = sorted(float(b) for b in buckets)
        if not bs or bs[-1] != math.inf:
            bs.append(math.inf)
        self.buckets: Tuple[float, ...] = tuple(bs)
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0

    def _make_child(self):
        return Histogram(self.name, self.help, (), self.buckets)

    def observe(self, v: float) -> None:
        self._check_unlabeled()
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    break

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile (Prometheus ``histogram_quantile``
        semantics): find the bucket holding rank ``q * count`` and assume
        observations are uniform within it.  The first bucket's lower edge
        is 0 (non-negative observations assumed — durations and delays,
        which is what these histograms hold); ranks landing in the +Inf
        bucket return the last finite edge, the same saturation Prometheus
        applies.  NaN on an empty histogram."""
        self._check_unlabeled()
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile wants q in [0, 1], got {q}")
        with self._lock:
            n = self._count
            counts = list(self._counts)
        if n == 0:
            return math.nan
        rank = q * n
        cum = 0
        lo = 0.0
        for b, c in zip(self.buckets, counts):
            if c > 0 and cum + c >= rank:
                if math.isinf(b):
                    return lo
                return lo + (b - lo) * ((rank - cum) / c)
            cum += c
            if not math.isinf(b):
                lo = b
        return lo

    def samples(self):
        out = []
        for c in self._self_or_children():
            cum = 0
            for b, n in zip(c.buckets, c._counts):
                cum += n
                le = ("+Inf" if b == math.inf else _fmt_value(b),)
                out.append((self.name + "_bucket", c._labelvalues + ("__le__",) + le, cum))
            out.append((self.name + "_sum", c._labelvalues, c._sum))
            out.append((self.name + "_count", c._labelvalues, c._count))
        return out

    def to_json(self):
        def one(c):
            return {
                "count": c._count,
                "sum": c._sum,
                "buckets": {
                    ("+Inf" if b == math.inf else _fmt_value(b)): n
                    for b, n in zip(c.buckets, c._counts)
                },
            }

        if not self.labelnames:
            return one(self)
        return {
            _fmt_labels(self.labelnames, lv) or "": one(c)
            for lv, c in self._children.items()
        }

    def _payload(self):
        with self._lock:
            return {
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }

    def _merge_payload(self, payload) -> None:
        counts = payload["counts"]
        if len(counts) != len(self._counts):
            raise ValueError(
                f"{self.name}: cannot merge histogram with "
                f"{len(counts)} buckets into {len(self._counts)}"
            )
        with self._lock:
            for i, n in enumerate(counts):
                self._counts[i] += n
            self._sum += payload["sum"]
            self._count += payload["count"]


class MetricsRegistry:
    """A named collection of metric families with idempotent constructors:
    ``counter("x")`` returns the same family on every call, and re-declaring
    a name as a different kind or label schema is an error (the same contract
    prometheus_client enforces)."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_make(self, cls, name: str, help: str, labelnames, **kw) -> _Metric:
        name = sanitize_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kw)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"{name} already registered as {m.kind}{m.labelnames}; "
                f"requested {cls.kind}{tuple(labelnames)}"
            )
        want_buckets = kw.get("buckets")
        if want_buckets is not None:
            bs = sorted(float(b) for b in want_buckets)
            if not bs or bs[-1] != math.inf:
                bs.append(math.inf)
            if tuple(bs) != m.buckets:
                raise ValueError(
                    f"{name} already registered with buckets {m.buckets}; "
                    f"requested {tuple(bs)}"
                )
        return m

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_make(Histogram, name, help, labelnames, buckets=buckets)

    # ------------------------------------------------------------------ #
    # federation: registries cross process boundaries as plain
    # picklable snapshots; merge() folds a snapshot (or another registry)
    # into this one with counter sums, bucket-wise histogram addition, and
    # label-family union — the deterministic half of cross-process
    # telemetry (the caller supplies a deterministic merge order).

    def snapshot(self) -> Dict[str, dict]:
        """This registry's full state as a plain picklable dict:
        ``{name: {kind, help, labelnames, [buckets,] children}}`` where
        ``children`` is a sorted list of ``[labelvalues, payload]`` pairs
        (the unlabeled family is one child keyed by ``()``)."""
        with self._lock:
            families = sorted(self._metrics.values(), key=lambda m: m.name)
        out: Dict[str, dict] = {}
        for m in families:
            if m.labelnames:
                with m._lock:
                    pairs = sorted(m._children.items())
                children = [(lv, c._payload()) for lv, c in pairs]
            else:
                children = [((), m._payload())]
            entry: dict = {
                "kind": m.kind,
                "help": m.help,
                "labelnames": list(m.labelnames),
                "children": children,
            }
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
            out[m.name] = entry
        return out

    def merge(self, other) -> "MetricsRegistry":
        """Fold ``other`` — a :class:`MetricsRegistry` or a
        :meth:`snapshot` dict — into this registry: counters add,
        histograms add bucket-wise (bucket schemas must match), gauges
        take the incoming value, and labeled families union their
        children.  Re-declaring a name as a different kind or label
        schema raises, exactly like the constructors.  Returns ``self``
        so merges chain."""
        snap = other.snapshot() if isinstance(other, MetricsRegistry) else other
        kinds = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}
        for name in sorted(snap):
            entry = snap[name]
            cls = kinds[entry["kind"]]
            kw = {}
            if entry["kind"] == "histogram":
                kw["buckets"] = entry["buckets"]
            fam = self._get_or_make(
                cls, name, entry["help"], tuple(entry["labelnames"]), **kw
            )
            for labelvalues, payload in entry["children"]:
                child = (
                    fam.labels(*labelvalues) if fam.labelnames else fam
                )
                child._merge_payload(payload)
        return self

    # ------------------------------------------------------------------ #
    # exposition

    def prometheus_text(self) -> str:
        """The Prometheus text exposition format — what a ``/metrics``
        scrape endpoint would serve for this registry."""
        lines: List[str] = []
        with self._lock:
            families = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in families:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for sample_name, labelvalues, value in m.samples():
                # histogram buckets smuggle the 'le' label via the
                # ("__le__", v) convention in Histogram.samples
                if "__le__" in labelvalues:
                    i = labelvalues.index("__le__")
                    names = m.labelnames + ("le",)
                    values = labelvalues[:i] + (labelvalues[i + 1],)
                else:
                    names, values = m.labelnames, labelvalues
                lines.append(
                    f"{sample_name}{_fmt_labels(names, values)} {_fmt_value(value)}"
                )
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> Dict[str, dict]:
        """One JSON document: {name: {kind, help, value|children}}."""
        with self._lock:
            families = sorted(self._metrics.values(), key=lambda m: m.name)
        return {
            m.name: {"kind": m.kind, "help": m.help, "value": m.to_json()}
            for m in families
        }

    def write(self, prom_path=None, json_path=None) -> None:
        if prom_path is not None:
            with open(prom_path, "w") as f:
                f.write(self.prometheus_text())
        if json_path is not None:
            with open(json_path, "w") as f:
                json.dump(self.to_json(), f, indent=2, sort_keys=True)


def exposition(registry: MetricsRegistry) -> Tuple[bytes, str]:
    """The registry rendered for a scrape endpoint: the text
    exposition encoded to bytes plus the content type a conforming
    ``GET /metrics`` response declares."""
    return registry.prometheus_text().encode("utf-8"), PROM_CONTENT_TYPE


def process_rss_bytes() -> float:
    """This process's resident set size, in bytes — /proc when the
    platform has one, ``ru_maxrss`` (a high-water mark, the closest
    portable stand-in) otherwise, 0.0 when neither is readable."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return float(pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    except Exception:
        return 0.0


def process_gauges(registry: MetricsRegistry, *, clock=time.monotonic):
    """Arm the serving daemon's process self-gauges:
    ``process_uptime_seconds`` (seconds since this call, on ``clock``)
    and ``process_rss_bytes``.  Returns an ``update()`` closure that
    refreshes both (called once here, then by the daemon before every
    scrape).  Nothing registers until this is called — a registry that
    never serves stays byte-identical to before this function existed
    (pinned by tests/test_serve.py)."""
    uptime = registry.gauge(
        "process_uptime_seconds",
        "seconds this process has been serving",
    )
    rss = registry.gauge(
        "process_rss_bytes",
        "resident set size of this process (bytes)",
    )
    t0 = clock()

    def update() -> None:
        uptime.set(clock() - t0)
        rss.set(process_rss_bytes())

    update()
    return update


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """Process-wide default registry (tests construct their own)."""
    return _REGISTRY
