"""Perfetto/Chrome trace-event export of a replay's event stream.

The port's own copy of ``gpuschedule_tpu/obs/perfetto.py``; the document it
writes keeps that package's ``exporter`` tag, so the two packages' traces
of one stream are byte-equal (``tests/test_torch_obs.py``).

Converts the engine's structured events (``MetricsLog.events`` /
``events.jsonl``) into the Chrome trace-event JSON format, loadable in
ui.perfetto.dev or chrome://tracing — the "watch a trace replay as a
timeline" half of the observability layer:

- **one track per pod/slice**: events carry a ``track`` label derived from
  the granted allocation's geometry (``pod0/4x4@0,0`` for a TPU slice,
  ``gpu/s0n1`` for a GPU node set, ``pool`` for the flat cluster); each
  distinct label becomes a thread track, grouped into processes by its
  ``pod.../gpu/pool`` prefix;
- **one complete event ("ph":"X") per job occupancy interval**: a job
  occupies its track from ``start`` until the next ``preempt`` / ``migrate``
  / ``resize`` / ``finish`` boundary (migrate and resize close one interval
  and open the next, since the slice — or its size — changed);
- **instant events ("ph":"i")** for preempt / migrate / reject / revoke,
  pinned to the track the job occupied (rejects land on a dedicated
  admission track);
- **health tracks** (faults/): each fault scope gets a thread under the
  "health" process with a fault/repair instant pair and an "unhealthy"
  interval spanning the outage (overlapping outages on one scope nest
  FIFO; unrepaired ones extend to the horizon);
- **net tracks** (net/): each fabric link gets a thread under the "net"
  process with one utilization slice per constant-load interval (named
  by percentage); contention re-prices land as "net" instants on the
  affected job's occupancy track;
- scheduling-rationale payloads (the policies' ``why`` records) ride along
  in each slice's ``args``, so clicking an interval answers *which rule put
  this job here*.

Timestamps are simulated seconds scaled to microseconds — the exported
timeline is the *replay* clock.  Wall-clock span timelines (the tracer's)
are exported separately by ``Tracer.write_chrome``; the two clocks do not
pretend to share an axis.

Pure stdlib; streams from an events iterable, so a JSONL file at Philly
scale never needs to be held in memory alongside the output.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

_ADMISSION_TRACK = "admission"
_US = 1e6  # sim seconds -> trace microseconds

# Occupancy intervals close on preempt/finish/migrate/resize/rebind/revoke
# (migrate/resize/rebind also open the next one, carrying the post-move
# track/size); preempt/migrate/reject/revoke/fault/repair additionally emit
# instants.  Header records (no "event" key) and unknown kinds fall through
# harmlessly.  The dispatch lives in the trace_events elif chain below.


def track_label(detail: Any) -> str:
    """Human track name for an allocation's flavor-specific detail.

    Duck-typed on the detail dataclasses (SliceGeometry / MultiSliceGeometry
    / GpuPlacement / None) so the sim layer stays import-light."""
    if detail is None:
        return "pool"
    slices = getattr(detail, "slices", None)
    if slices is not None:  # multislice gang: one track spanning its pods
        return "dcn/" + "+".join(track_label(s) for s in slices)
    pod = getattr(detail, "pod", None)
    if pod is not None:
        shape = "x".join(str(s) for s in getattr(detail, "shape", ()))
        origin = ",".join(str(o) for o in getattr(detail, "origin", ()))
        return f"pod{pod}/{shape}@{origin}"
    nodes = getattr(detail, "nodes", None)
    if nodes is not None:  # GpuPlacement: (switch, node) ids
        return "gpu/" + "+".join(f"s{s}n{n}" for (s, n), _ in nodes)
    return str(detail)


def load_events_jsonl(path) -> Iterator[dict]:
    """Stream events back out of a ``MetricsLog`` JSONL file."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


class _TrackIds:
    """Stable (pid, tid) assignment: one process per track-name prefix
    (pod0, gpu, pool, dcn, admission), one thread per full track name."""

    def __init__(self):
        self._pids: Dict[str, int] = {}
        self._tids: Dict[str, Tuple[int, int]] = {}
        self.meta: List[dict] = []

    def ids(self, track: str) -> Tuple[int, int]:
        got = self._tids.get(track)
        if got is not None:
            return got
        group = track.split("/", 1)[0]
        pid = self._pids.get(group)
        if pid is None:
            pid = len(self._pids) + 1
            self._pids[group] = pid
            self.meta.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": group},
            })
        tid = sum(1 for t in self._tids if t.split("/", 1)[0] == group) + 1
        self._tids[track] = (pid, tid)
        self.meta.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": track},
        })
        return pid, tid


def trace_events(events: Iterable[dict]) -> List[dict]:
    """Convert an ordered event stream into Chrome trace events (without the
    enclosing document).  Metadata records lead, then timed records sorted by
    ``ts`` (the input stream is time-ordered by construction; a defensive
    sort keeps the output valid even for hand-edited streams)."""
    ids = _TrackIds()
    timed: List[dict] = []
    # job -> (track, start_ts_us, args) for the open occupancy interval
    open_iv: Dict[str, Tuple[str, float, dict]] = {}
    # net/ link -> (start_ts_us, args) for the open utilization slice
    open_net: Dict[str, Tuple[float, dict]] = {}
    # fault track (health/<scope> or domain/<scope>) -> open outages as
    # (start_ts_us, args) entries.
    # Engine-emitted events carry a per-record "fid" so a repair closes ITS
    # outage even when outages of different durations overlap on one scope;
    # fid-less streams (hand-edited) fall back to oldest-first pairing.
    open_health: Dict[str, List[Tuple[float, dict]]] = {}
    t_last = 0.0

    def close(job: str, t_us: float, note: Optional[str] = None) -> None:
        iv = open_iv.pop(job, None)
        if iv is None:
            return
        track, t0, args = iv
        if note is not None:
            args = {**args, "ended_by": note}
        pid, tid = ids.ids(track)
        timed.append({
            "name": job, "cat": "occupancy", "ph": "X",
            "ts": t0, "dur": max(0.0, t_us - t0),
            "pid": pid, "tid": tid, "args": args,
        })

    def instant(name: str, track: str, t_us: float, args: dict) -> None:
        pid, tid = ids.ids(track)
        timed.append({
            "name": name, "cat": "transition", "ph": "i", "s": "t",
            "ts": t_us, "pid": pid, "tid": tid, "args": args,
        })

    def close_net(track: str, t_us: float) -> None:
        """Close one link's open utilization slice (net/ tracks: one
        slice per constant-utilization interval, named by percentage)."""
        iv = open_net.pop(track, None)
        if iv is None:
            return
        t0, args = iv
        pid, tid = ids.ids(track)
        timed.append({
            "name": f"{100.0 * float(args.get('util', 0.0)):.0f}%",
            "cat": "net", "ph": "X",
            "ts": t0, "dur": max(0.0, t_us - t0),
            "pid": pid, "tid": tid, "args": args,
        })

    for ev in events:
        kind = ev.get("event")
        t_us = float(ev.get("t", 0.0)) * _US
        t_last = max(t_last, t_us)
        job = ev.get("job", "?")
        extra = {
            k: v for k, v in ev.items() if k not in ("event", "t", "job", "track")
        }
        if kind == "start":
            close(job, t_us, "restart")  # defensive: stream said start twice
            track = ev.get("track") or f"job/{job}"
            open_iv[job] = (track, t_us, extra)
        elif kind in ("migrate", "resize", "rebind"):
            iv = open_iv.get(job)
            old_track = iv[0] if iv else ev.get("track") or f"job/{job}"
            close(job, t_us, kind)
            if kind == "migrate":
                instant("migrate", old_track, t_us, extra)
            new_track = ev.get("track") or old_track
            args = dict(iv[2]) if iv else {}
            args.update(extra)
            open_iv[job] = (new_track, t_us, args)
        elif kind in ("preempt", "revoke"):
            iv = open_iv.get(job)
            track = iv[0] if iv else f"job/{job}"
            close(job, t_us, kind)
            instant(kind, track, t_us, extra)
        elif kind == "finish":
            close(job, t_us, ev.get("end_state", "finish"))
        elif kind == "reject":
            instant("reject", _ADMISSION_TRACK, t_us, extra)
        elif kind in ("fault", "repair"):
            # unhealthy-interval tracks: one thread per fault scope under
            # the "health" process, an X slice per outage.  Correlated
            # domain outages get their own "domain" process so
            # the blast-radius hierarchy reads as one track group.
            label = str(ev.get("scope", "?"))
            group = "domain" if ev.get("fault") == "domain" else "health"
            track = f"{group}/{label}"
            instant(kind, track, t_us, extra)
            if kind == "fault":
                open_health.setdefault(track, []).append((t_us, extra))
            else:
                stack = open_health.get(track)
                if stack:
                    fid = extra.get("fid")
                    at = next(
                        (i for i, (_, a) in enumerate(stack)
                         if fid is not None and a.get("fid") == fid),
                        0,
                    )
                    h0, args = stack.pop(at)
                    pid, tid = ids.ids(track)
                    timed.append({
                        "name": "unhealthy", "cat": "health", "ph": "X",
                        "ts": h0, "dur": max(0.0, t_us - h0),
                        "pid": pid, "tid": tid, "args": args,
                    })
        elif kind in ("net", "slow", "warn", "reroute"):
            # contention re-price / straggler re-price / spot pre-revoke
            # notice / adaptive-routing route change: instants on the
            # job's occupancy track
            iv = open_iv.get(job)
            instant(kind, iv[0] if iv else f"job/{job}", t_us, extra)
        elif kind == "netlink":
            # per-link utilization slices: one thread per fabric link
            # under the "net" process, a slice per constant-load interval
            track = f"net/{ev.get('link', '?')}"
            close_net(track, t_us)
            open_net[track] = (t_us, extra)
        elif kind == "sample":
            # periodic cluster samples become counter tracks
            # ("ph":"C") under a "cluster" process: physical occupancy
            # (used + health-masked chips stack) and queue depth — the
            # two signals ui.perfetto.dev graphs as area charts above
            # the per-pod occupancy timelines
            pid, tid = ids.ids("cluster/occupancy")
            timed.append({
                "name": "physical chips", "cat": "sample", "ph": "C",
                "ts": t_us, "pid": pid, "tid": tid,
                "args": {
                    "used": ev.get("used", 0),
                    "unhealthy": ev.get("unhealthy", 0),
                },
            })
            pid, tid = ids.ids("cluster/queue")
            timed.append({
                "name": "pending jobs", "cat": "sample", "ph": "C",
                "ts": t_us, "pid": pid, "tid": tid,
                "args": {"pending": ev.get("pending", 0)},
            })
            pods = ev.get("pods")
            if pods and any("hazard" in p for p in pods):
                # per-pod hazard health track: present only on
                # hazard-armed captures, so historical traces are
                # byte-identical
                pid, tid = ids.ids("cluster/hazard")
                timed.append({
                    "name": "pod hazard", "cat": "sample", "ph": "C",
                    "ts": t_us, "pid": pid, "tid": tid,
                    "args": {
                        f"pod{i}": float(p.get("hazard", 0.0))
                        for i, p in enumerate(pods)
                    },
                })
        # arrival / speed / rationale-only events carry no timeline geometry

    # horizon cutoff: unfinished occupancies and unrepaired outages extend
    # to the last seen time
    for job in list(open_iv):
        close(job, t_last, "horizon")
    for track in list(open_net):
        close_net(track, t_last)
    for track, stack in open_health.items():
        pid, tid = ids.ids(track)
        for h0, args in stack:
            timed.append({
                "name": "unhealthy", "cat": "health", "ph": "X",
                "ts": h0, "dur": max(0.0, t_last - h0),
                "pid": pid, "tid": tid,
                "args": {**args, "ended_by": "horizon"},
            })

    timed.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "X" else 1))
    return ids.meta + timed


def fleet_trace_events(
    parent_events: List[dict],
    workers: Dict[str, List[dict]],
    *,
    parent_name: str = "parent",
) -> List[dict]:
    """Merge parent-side and per-worker span events into one Chrome trace
    event list with process/thread metadata records: the parent
    is pid 1 (named ``parent_name``), each worker key gets its own named
    pid in sorted-key order, and every timed event is stamped with its
    process ids and globally re-sorted by ts — the shape ui.perfetto.dev
    renders as one fleet timeline with a named track per worker.

    Each process's ``ts`` values are on its own wall anchor (the standard
    multi-process Chrome-trace situation); within a process the layout is
    real.  The output is a pure function of the inputs: worker keys sort,
    ties break on (ts, pid, tid, name), so adversarial completion order
    upstream cannot change a byte here.
    """
    meta: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": parent_name}},
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": 1,
         "args": {"name": "spans"}},
    ]
    timed: List[dict] = []
    for e in parent_events:
        timed.append({**e, "pid": 1, "tid": 1})
    for i, key in enumerate(sorted(workers)):
        pid = i + 2
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": key}})
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": 1, "args": {"name": "spans"}})
        for e in workers[key]:
            timed.append({**e, "pid": pid, "tid": 1})
    timed.sort(key=lambda e: (e["ts"], e["pid"], e["tid"], e["name"]))
    return meta + timed


def export_chrome_trace(events: Iterable[dict], out_path) -> dict:
    """Write ``events`` as a Chrome trace-event JSON document; returns the
    document (handy for tests)."""
    doc = {
        "traceEvents": trace_events(events),
        "displayTimeUnit": "ms",
        "otherData": {"clock": "simulated", "exporter": "gpuschedule_tpu.obs"},
    }
    out = Path(out_path)
    if out.parent and not out.parent.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f)
    return doc


def validate_chrome_trace(doc: dict) -> List[str]:
    """Schema sanity: returns a list of violations (empty = valid).  The
    checks mirror what ui.perfetto.dev's importer requires: the traceEvents
    array, per-event phase/ts/pid/tid fields, non-negative durations, and
    time-ordered timed events."""
    problems: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    last_ts = None
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            problems.append(f"[{i}] not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "M", "C", "b", "e"):
            problems.append(f"[{i}] unknown phase {ph!r}")
            continue
        if not isinstance(e.get("name"), str):
            problems.append(f"[{i}] name missing")
        if ph == "M":
            continue
        for k in ("ts", "pid", "tid"):
            if not isinstance(e.get(k), (int, float)):
                problems.append(f"[{i}] {k} missing/non-numeric")
        if ph == "X" and (not isinstance(e.get("dur"), (int, float)) or e["dur"] < 0):
            problems.append(f"[{i}] complete event needs dur >= 0")
        if ph == "i" and e.get("s") not in (None, "t", "p", "g"):
            problems.append(f"[{i}] bad instant scope {e.get('s')!r}")
        ts = e.get("ts")
        if isinstance(ts, (int, float)):
            if ts < 0:
                problems.append(f"[{i}] negative ts")
            if last_ts is not None and ts < last_ts:
                problems.append(f"[{i}] ts decreases ({ts} < {last_ts})")
            last_ts = ts
    return problems
