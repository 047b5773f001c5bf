"""Engine snapshot / restore / fork.

The port's own copy of ``gpuschedule_tpu/sim/snapshot.py``.  A snapshot
pickles the port's classes, so it is not the JAX package's snapshot; the
loader refuses a snapshot that names that package's classes.  What a
resume produces is the same.

One snapshot is the **complete** mid-replay engine state, serialized as a
single pickle graph so every cross-reference keeps its identity — the
jobs in the heap are the jobs in the pending set are the jobs the policy
holds scratch state for.  Restoring in a fresh process re-enters the run
loop between two batches and finishes the replay:

- **v1 accounting**: the resumed tail is byte-identical to the
  uninterrupted run — events.jsonl (truncated to the snapshot's recorded
  sink offset, then appended), jobs.csv, utilization.csv and
  counters.json all hash equal (tests/test_torch_snapshot.py);
- **v2 accounting**: closure-exact under the documented v2 summation
  order (docs/performance.md).

What makes this tractable:

- the engine is **RNG-free by construction** — every stochastic stream
  (trace synthesis, fault schedules) is pregenerated into the spec list
  before the run starts, and the one live RNG in the stack (the GPU
  cluster's random placement scheme) pickles its exact stream state;
- id()-keyed indices (fault ids, warned-job sets, net members, link
  degrade sites) are remapped through stable fault-record indices across
  the process boundary;
- derived caches are shed or invalidated on restore (cluster
  ``__getstate__`` / ``restored()``, ``NetModel.restored()``), so a
  resume re-derives geometry instead of trusting pre-snapshot state;
- the v2 ledger is rebuilt from the restored running set (its columns
  are a pure derived cache of the job fields).

Format: ``MAGIC + pickle({"version": SNAPSHOT_VERSION, "state": ...})``,
written atomically (tmp + rename).  Bump :data:`SNAPSHOT_VERSION` when
the captured state changes incompatibly; loaders refuse mismatches
instead of mis-restoring.
"""

from __future__ import annotations

import io
import math
import os
import pickle
from pathlib import Path
from typing import Optional

MAGIC = b"GSTPU-SNAP\n"
SNAPSHOT_VERSION = 1

# Engine attributes that must NOT ride the pickle graph: process-bound
# objects (tracer, profiler, metrics with its file handles) and the
# id()-keyed indices that are captured in remapped form instead.
_ENGINE_SKIP = frozenset({
    "metrics", "_tracer", "_profiler", "_ledger", "_lv",
    "_fault_ids", "_warned_jobs", "_net_members",
})

# MetricsLog state that rides the snapshot (file handles and the registry
# are process-bound and excluded; the sink is captured as path + offset).
_METRICS_FIELDS = (
    "job_rows", "util_samples", "counters", "events",
    "max_util_samples", "_stride", "_sample_calls", "_last_t",
    "_last_frac", "_util_area", "_util_horizon", "_tail",
    "run_meta", "_header_emitted", "attribution", "record_events",
    "cache_telemetry", "_all_jobs",
)


def snapshot_state(sim, *, flush_sink: bool = True) -> dict:
    """The picklable state dict for one simulator (shared by file
    snapshots and in-memory forks)."""
    engine = {
        k: v for k, v in sim.__dict__.items() if k not in _ENGINE_SKIP
    }
    # id()-keyed indices, remapped through stable indices/lists
    records = sim.faults.records if sim.faults is not None else []
    fault_index = sim._fault_ids  # id(rec) -> stable index
    warned = {
        fault_index[key]: set(jobs)
        for key, jobs in sim._warned_jobs.items()
        if key in fault_index
    }
    net_members = list(sim._net_members.values())
    degrade_sites = None
    if sim.net is not None:
        sites = getattr(sim.net, "_degrade_sites", None)
        if sites:
            # engine-driven keys are id(record); foreign keys (direct API
            # users) cannot cross a process boundary and are dropped
            degrade_sites = {
                fault_index[key]: site
                for key, site in sites.items()
                if key in fault_index
            }
    metrics = sim.metrics
    sink_path = None
    sink_offset = None
    if metrics._sink_path is not None or metrics._sink_fh is not None:
        if flush_sink:
            metrics.flush_events()
        if metrics._sink_path is not None:
            sink_path = str(metrics._sink_path)
            fh = metrics._sink_fh
            if fh is not None:
                fh.flush()
                sink_offset = fh.tell()
            else:
                # lazy sink never opened: nothing streamed yet
                sink_offset = 0
        else:
            # caller-owned file object: position if it supports it
            try:
                metrics._sink_fh.flush()
                sink_offset = metrics._sink_fh.tell()
            except (OSError, ValueError, AttributeError):
                sink_offset = None
    mstate = {name: getattr(metrics, name) for name in _METRICS_FIELDS}
    return {
        "engine": engine,
        "records": records,
        "warned": warned,
        "net_members": net_members,
        "net_degrade_sites": degrade_sites,
        "metrics": mstate,
        "sink_path": sink_path,
        "sink_offset": sink_offset,
    }


def save_snapshot(sim, path) -> Path:
    """Atomically write ``sim``'s full state to ``path``."""
    out = Path(path)
    if out.parent and not out.parent.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
    state = snapshot_state(sim)
    tmp = out.with_name(out.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        pickle.dump(
            {"version": SNAPSHOT_VERSION, "state": state}, f, protocol=4
        )
    os.replace(tmp, out)
    return out


class SnapshotError(ValueError):
    """Unreadable / wrong-magic / wrong-version snapshot file."""


class _OwnClassesUnpickler(pickle.Unpickler):
    """Refuses the JAX package's classes.  Its snapshots share
    :data:`MAGIC` and :data:`SNAPSHOT_VERSION`, so only the pickled module
    paths tell them apart; loading one would import ``gpuschedule_tpu``
    into this process and finish the replay with its objects."""

    def __init__(self, data: bytes, path: Path):
        super().__init__(io.BytesIO(data))
        self._path = path

    def find_class(self, module, name):
        if module.split(".", 1)[0] == "gpuschedule_tpu":
            raise SnapshotError(
                f"{self._path}: snapshot of another package ({module}.{name}); "
                f"resume it with the package that wrote it"
            )
        return super().find_class(module, name)


def load_snapshot(path, *, metrics=None, events_sink=None, profiler=None):
    """Reconstruct a :class:`~gpuschedule_tpu_torch.sim.engine.Simulator` from
    a snapshot file.

    ``metrics`` supplies a fresh :class:`MetricsLog` shell to restore the
    accumulated state into (one is built when omitted); ``events_sink``
    overrides the recorded sink path (the default reopens the recorded
    path, truncated to the recorded offset, so the resumed tail appends
    exactly where the snapshot left off).  The obs registry and tracer
    are process-bound and NOT resumed — counters.json and the event
    stream are exact; metrics.prom counts only the tail.
    """
    p = Path(path)
    try:
        raw = p.read_bytes()
    except OSError as e:
        raise SnapshotError(f"cannot read snapshot {p}: {e}") from None
    if not raw.startswith(MAGIC):
        raise SnapshotError(f"{p} is not an engine snapshot (bad magic)")
    try:
        doc = _OwnClassesUnpickler(raw[len(MAGIC):], p).load()
    except SnapshotError:
        raise
    except Exception as e:  # corrupt pickle: refuse loudly, not halfway
        raise SnapshotError(f"{p}: corrupt snapshot payload: {e}") from None
    version = doc.get("version")
    if version != SNAPSHOT_VERSION:
        raise SnapshotError(
            f"{p}: snapshot version {version!r} != supported "
            f"{SNAPSHOT_VERSION} (re-snapshot with this build)"
        )
    return _restore(doc["state"], metrics=metrics, events_sink=events_sink,
                    profiler=profiler)


def state_to_bytes(sim) -> bytes:
    """One simulator's complete state as a transportable byte string —
    what the what-if worker pool ships to each worker so it can mirror
    the live engine once and then serve many :func:`fork`-per-query
    replays.  The parent's sink stays attached and unflushed;
    clones built from these bytes always detach it."""
    state = snapshot_state(sim, flush_sink=False)
    buf = io.BytesIO()
    pickle.dump(state, buf, protocol=4)
    return buf.getvalue()


def clone_from_state_bytes(data: bytes):
    """Reconstruct a fully independent, silently-observing simulator
    from :func:`state_to_bytes` output — in this process or another.
    The clone carries the full accounting history but writes nowhere:
    no event stream, buffered events dropped, periodic snapshotting
    disarmed (a speculative replay must never overwrite the parent's
    checkpoint file).

    This is the what-if service's per-query fork: a paused mirror's
    state bytes are invariant across queries, so each worker serializes
    once and clones by unpickle alone — half the full dump+load round
    trip, and fork latency IS query latency.  The collector
    pauses across the load (burst allocation trips gc generations for
    ~15% of the latency; nothing here creates cycles)."""
    import gc

    paused = gc.isenabled()
    if paused:
        gc.disable()
    try:
        state = pickle.loads(data)
    finally:
        if paused:
            gc.enable()
    state["sink_path"] = None
    state["sink_offset"] = None
    clone = _restore(state, metrics=None, events_sink=False, profiler=None)
    clone.metrics.record_events = False
    clone.metrics.events = []
    clone._snap_path = None
    clone._snap_every = None
    clone._snap_next = math.inf
    return clone


def fork_simulator(sim):
    """In-memory deep copy via the same state capture (identity-preserving
    pickle round trip), with the event stream detached: the fork carries
    the full accounting history but writes nowhere.

    The collector is paused across the dump half too (the load half
    pauses inside :func:`clone_from_state_bytes`): pickling a
    100k-object graph allocates in bursts that trip gc generations
    several times, ~15% of fork latency."""
    import gc

    paused = gc.isenabled()
    if paused:
        gc.disable()
    try:
        data = state_to_bytes(sim)
    finally:
        if paused:
            gc.enable()
    return clone_from_state_bytes(data)


# --------------------------------------------------------------------- #
# restore internals


def _restore_metrics(state: dict, *, metrics=None, events_sink=None):
    from gpuschedule_tpu_torch.sim.metrics import MetricsLog

    m = metrics if metrics is not None else MetricsLog()
    for name in _METRICS_FIELDS:
        setattr(m, name, state["metrics"][name])
    sink = None
    if events_sink is False:       # fork: explicitly no sink
        sink = None
    elif events_sink is not None:  # caller override
        sink = Path(events_sink)
    elif state["sink_path"] is not None:
        sink = Path(state["sink_path"])
    if sink is not None:
        offset = state["sink_offset"] or 0
        sink.parent.mkdir(parents=True, exist_ok=True)
        # reopen at the snapshot's byte offset: anything streamed after
        # the snapshot (the crashed tail) is discarded, and the resumed
        # replay appends exactly where the snapshot-consistent prefix
        # ends — what makes head + tail equal the uninterrupted bytes.
        # The offset only means anything for a file that actually holds
        # the prefix (the recorded sink, or a copy of it); clamp to the
        # file's real size so a fresh/shorter override sink gets the
        # tail appended from where it ends instead of a NUL-padded head
        cur = sink.stat().st_size if sink.exists() else 0
        offset = min(offset, cur)
        fh = open(sink, "a+")
        fh.truncate(offset)
        fh.seek(offset)
        m._sink_path = sink
        m._sink_fh = fh
        m._owns_sink = True
        m._sink_opened = True
    return m


def _restore(state: dict, *, metrics=None, events_sink=None, profiler=None):
    from gpuschedule_tpu_torch.obs.tracer import get_tracer
    from gpuschedule_tpu_torch.sim.engine import Simulator

    sim = object.__new__(Simulator)
    sim.__dict__.update(state["engine"])
    sim._tracer = get_tracer()
    sim._profiler = profiler
    sim.metrics = _restore_metrics(
        state, metrics=metrics, events_sink=events_sink
    )
    sim.metrics.attach_jobs(sim.jobs)
    # rebuild the id()-keyed indices against this process's identities
    records = state["records"]
    sim._fault_ids = {id(rec): i for i, rec in enumerate(records)}
    sim._warned_jobs = {
        id(records[i]): jobs for i, jobs in state["warned"].items()
    }
    sim._net_members = {id(j): j for j in state["net_members"]}
    if sim.net is not None:
        if state["net_degrade_sites"] is not None:
            sim.net._degrade_sites = {
                id(records[i]): site
                for i, site in state["net_degrade_sites"].items()
            }
        sim.net.restored()
    cluster = getattr(sim.cluster, "inner", sim.cluster)
    cluster.restored()
    # v2 ledger: a pure derived cache — rebuild from the running set
    sim._ledger = None
    sim._lv = None
    if sim._lazy:
        from gpuschedule_tpu_torch.sim.ledger import JobLedger

        sim._ledger = JobLedger(
            attribution=sim.attribution,
            vector=bool(getattr(sim.policy, "reads_progress", True)),
        )
        if sim._ledger.vector:
            sim._lv = sim._ledger
            for job in sim.running:
                sim._lv.bind(job)
    sim._snap_restores += 1
    return sim
