"""The world-flag -> config-hash table: ONE source of truth.

Every CLI knob reachable from ``_add_world_args`` or defined on a
world-building subparser (``run``, ``whatif``) is accounted for here, in
exactly one of three buckets:

- ``HASHED``: always part of the experiment config hash, under its
  argparse dest name (the hash dict key EQUALS the dest, which is what
  keeps every historical hash byte-identical — do not rename either side
  independently).
- ``HASHED_WHEN_ARMED``: rides the hash only when armed (value differs
  from the disarmed default AND is truthy) — a knob-off run's hash (and
  therefore its run_id and events header) must stay byte-identical to
  what it was before the knob existed.
- ``UNHASHED``: deliberately outside the hash, each with a one-line
  justification.  Output/telemetry knobs never change replay semantics;
  policy-side knobs are excluded so ``compare`` accepts policy-A-vs-B
  runs of the same seeded world.

``cli.py:_run_config_hash`` consumes this table at runtime.  This is the
port's own copy of ``gpuschedule_tpu/worldspec.py``: the same dests in the
same buckets, so a run's ``config_hash`` (and with it its ``run_id`` and
events header) equals the JAX package's for the same flags
(``tests/test_torch_obs.py``).
"""

from __future__ import annotations

# Always hashed: dest name == hash key, values taken verbatim from args.
HASHED = (
    "cluster",
    "chips",
    "dims",
    "pods",
    "gpu_shape",
    "placement",
    "placement_seed",
    "philly",
    "trace",
    "synthetic",
    "seed",
    "arrival_rate",
    "mean_duration",
    "failure_rate",
    "util_min",
    "max_job_chips",
    "max_time",
    "faults",
)

# Hashed only when armed: dest -> disarmed default.  The knob joins the
# hash dict (key == dest, value == the armed arg value) only when the
# value is truthy and differs from the disarmed default:
# - net: only present when --net is on — a net-free run's hash must stay
#   byte-identical to before the net layer existed;
# - accounting: v2 changes the float-summation contract (exact-sum
#   closure replaces byte-identity), so it IS experiment config — but
#   only when armed, keeping every historical v1 hash byte-identical.
HASHED_WHEN_ARMED = {
    "net": None,
    "accounting": "v1",
}

# Deliberately unhashed, each with its one-line justification.
UNHASHED = {
    # -- policy-side world flags (the hash covers cluster + trace +
    #    faults, deliberately NOT the policy, so policy-A-vs-B runs of
    #    the same world stay compare-compatible) --
    "policy": "policy identity is deliberately outside the experiment "
              "hash so A-vs-B policy runs of one world are comparable",
    "policy_arg": "policy constructor kwargs are policy identity, not "
                  "world config",
    "curves": "goodput curve cache feeds the optimus policy, not the "
              "world",
    "online": "live profiling is an optimus policy input, not world "
              "config",
    # -- run-only output / telemetry knobs (replay-neutral by pinned
    #    byte-identity contracts) --
    "out": "output directory choice never changes replay semantics",
    "prefix": "output filename prefix only",
    "events": "event recording is observational; recorded runs are "
              "byte-identical to unrecorded ones",
    "perfetto": "trace export is derived from the event stream, "
                "replay-neutral",
    "spans": "span tracing is gated at <=2% overhead and replay-neutral",
    "attrib": "attribution is additive bookkeeping; off-path runs are "
              "byte-identical",
    "sample_interval": "sample events never perturb the replay "
                       "(byte-identity pinned)",
    "sample_on_change": "on-change samples never perturb the replay "
                        "(byte-identity pinned)",
    "self_profile": "wall-clock self-profiling leaves replay output "
                    "byte-identical",
    "cache_stats": "cache telemetry harvests counters after the replay "
                   "finished",
    "prom": "metrics exposition format output only",
    "history": "history rows record results; they never feed back into "
               "the replay",
    "snapshot": "periodic snapshot writes are between-batch and "
                "replay-neutral (resume byte-identity pinned)",
    "flush_events": "sink flush cadence changes when bytes reach disk, "
                    "never which bytes (tailable-sink contract)",
    "snapshot_every": "snapshot cadence, replay-neutral with --snapshot",
    "resume": "a resumed run's world comes from the snapshot, not the "
              "flags; finished outputs are byte-identical under v1",
    # -- whatif-only query flags: they select what to ASK of
    #    the mirrored world — queries evaluate on speculative forks and
    #    are never part of the world's identity --
    "at": "the mirror instant selects where to pause, not which world",
    "horizon": "speculative-replay budget per query, fork-side only",
    "pool": "worker-process count; serial and pooled documents are "
            "pinned identical",
    "admit": "admit queries evaluate on forks of the mirrored world",
    "drain": "drain queries evaluate on forks of the mirrored world",
    "swap_policy": "policy-swap queries evaluate on forks; policy is "
                   "outside the hash by design",
    "trace_out": "merged fleet-trace export is derived telemetry; "
                 "disarmed and armed runs are byte-identical",
    # -- serve-only daemon flags: the HTTP edge over the
    #    mirrored world — where it listens and how it drains never
    #    touch which world it serves (served-vs-offline byte identity
    #    pinned) --
    "host": "listen address is deployment plumbing, not world config",
    "port": "listen port is deployment plumbing, not world config",
    "follow": "stream drive mode; the alert sequence is pinned "
              "identical across batch/replay/follow",
    "replay": "stream drive mode; alert sequence pinned identical "
              "across modes",
    "speed": "replay pacing delays delivery only; alert content is "
             "keyed to sim time alone",
    "poll": "follow-mode poll cadence is wall-clock delivery, never "
            "alert content",
    "idle_timeout": "follow-mode stop condition, delivery-side only",
    "max_wall": "wall-clock serving budget, delivery-side only",
    "rules": "detector thresholds select what to alert on, not which "
             "world runs; the rules hash rides the alert header",
    "window": "detector window length, alert-side only (rides the "
              "alert header's rules hash)",
    "alerts": "alert side-stream output path only",
    "max_inflight": "admission-queue depth backpressures askers; "
                    "served documents are pinned identical to offline",
    "self_slo": "the daemon's own SLO thresholds watch the server, "
                "not the world",
    "drain_s": "shutdown drain budget is wall-clock edge behavior "
               "only",
}


def hash_config(args) -> dict:
    """The experiment-config dict ``cli.py:_run_config_hash`` digests —
    built from the table above, the one source of truth."""
    config = {dest: getattr(args, dest) for dest in HASHED}
    for dest, disarmed in HASHED_WHEN_ARMED.items():
        value = getattr(args, dest, disarmed)
        if value and value != disarmed:
            config[dest] = value
    return config
