"""Modeled checkpoint/restore costs, parameterized per model and slice size.

The port's own copy of ``gpuschedule_tpu/sim/overhead.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_sim*.py`` hold its replays equal
to the original's, to the bit.

The reference charges fixed suspend/resume and migration constants
(SURVEY.md §5 "Checkpoint / resume": costs are modeled, not real).  This
module is the TPU-native refinement "parameterized per slice size": the cost of bringing a preempted job back
is a fixed framework setup term plus the time to stream its training state
back through the hosts that feed the slice —

    restore_s(model, chips, gen) = base_s
        + ckpt_bytes(model) / (hosts(chips, gen) * host_gbps / 8 * 1e9)

- ``ckpt_bytes`` = 12 bytes/param (f32 master weights + two Adam moments),
  i.e. what orbax would actually persist for the train states built in
  :mod:`gpuschedule_tpu_torch.parallel.train`;
- ``hosts`` = chips / chips_per_host for the generation: a bigger slice has
  more hosts pulling shards in parallel, so restore *speeds up* with slice
  size while growing with model size — the shape the fixed constants miss;
- migration pays save + restore (2x the transfer) on top of the base term.

Pure Python over :data:`~gpuschedule_tpu_torch.models.config.MODEL_CONFIGS` and
the generation table — nothing of the device layer.

**Measured vs modeled** (the JAX package's tests/test_elastic_loop.py): an
engine-driven Optimus shrink executing the REAL orbax save+restore of a
transformer-tiny ShardedTrainer (8 -> 4 devices, ~17 MB of train state,
CPU mesh + local disk) measures ~0.3-3 s of mechanism time against
``migrate_seconds('transformer-tiny', 4)`` ~= 5.0 s — the same order of
magnitude, with the modeled figure dominated by the ``base_s`` floor
standing in for process-restart/compile costs the in-process measurement
does not pay.  The test pins the agreement to within two orders.
"""

from __future__ import annotations

import math

from gpuschedule_tpu_torch.cluster.tpu import DCN_GBPS, GENERATIONS
from gpuschedule_tpu_torch.models.config import resolve_model_config

# Framework teardown/setup floor (process restart, compile-cache hit, data
# pipeline rewind) — the part of Gandiva's observed suspend/resume cost that
# does not scale with state size.
DEFAULT_BASE_S = 5.0

BYTES_PER_PARAM = 12  # f32 params + 2 Adam moments


def ckpt_bytes(model_name: str) -> int:
    """Persisted training-state size for a model (params + opt state).

    Unknown model names (e.g. straight from a Philly trace) resolve through
    the shared zoo-median fallback (models/config.py), the same phantom
    model that prices their DCN toll — one job, one consistent size."""
    return BYTES_PER_PARAM * resolve_model_config(model_name).param_count


def restore_seconds(
    model_name: str,
    chips: int,
    *,
    generation: str = "v5e",
    base_s: float = DEFAULT_BASE_S,
    host_gbps: float = DCN_GBPS,
    round_trips: int = 1,
) -> float:
    """Seconds to resume a suspended job on a ``chips``-chip slice.

    ``round_trips=2`` models migration (save on the old slice + load on the
    new one); 1 models resume-from-checkpoint where the save already
    happened at suspend time, off the critical path.
    """
    if chips < 1:
        raise ValueError(f"chips must be >= 1, got {chips}")
    spec = GENERATIONS[generation]
    hosts = max(1, math.ceil(chips / spec["chips_per_host"]))
    bytes_per_s = hosts * host_gbps * 1e9 / 8.0
    return base_s + round_trips * ckpt_bytes(model_name) / bytes_per_s


def migrate_seconds(model_name: str, chips: int, *, generation: str = "v5e") -> float:
    """Modeled migration cost: save + restore across congruent slices."""
    return restore_seconds(model_name, chips, generation=generation, round_trips=2)


# Fixed floor of one checkpoint *write*: flushing device buffers and
# committing the manifest — much smaller than the restore floor because no
# process restart or compile is on this path.
CKPT_WRITE_BASE_S = 1.0


def ckpt_write_seconds(
    model_name: str,
    chips: int,
    *,
    generation: str = "v5e",
    base_s: float = CKPT_WRITE_BASE_S,
    host_gbps: float = DCN_GBPS,
) -> float:
    """Seconds one periodic checkpoint WRITE takes on a ``chips``-chip
    slice: the same state-streaming transfer as :func:`restore_seconds`
    (every host pushes its shard in parallel, so bigger slices write
    faster while bigger models write slower) over a much smaller fixed
    floor.  This is what ``RecoveryModel.ckpt_write="auto"`` charges the
    ``overhead`` leg every ``ckpt_interval`` work-seconds — the priced-
    recovery half of the checkpoint trade (the other half is the lost
    work a revocation rolls back)."""
    if chips < 1:
        raise ValueError(f"chips must be >= 1, got {chips}")
    spec = GENERATIONS[generation]
    hosts = max(1, math.ceil(chips / spec["chips_per_host"]))
    bytes_per_s = hosts * host_gbps * 1e9 / 8.0
    return base_s + ckpt_bytes(model_name) / bytes_per_s


def cluster_generation(cluster) -> str:
    """Best-effort generation lookup for overhead modeling (v5e default)."""
    gen = getattr(cluster, "generation", None)
    return gen if gen in GENERATIONS else "v5e"


def resolve_overhead(spec, job, cluster, *, migration: bool = False) -> float:
    """Interpret a policy's overhead knob: a number is used as-is; the
    string ``"auto"`` derives the cost from the job's model and gang size."""
    if spec == "auto":
        fn = migrate_seconds if migration else restore_seconds
        return fn(
            job.model_name,
            max(1, job.allocated_chips or job.num_chips),
            generation=cluster_generation(cluster),
        )
    return float(spec)
