"""Command line: ``python -m gpuschedule_tpu_torch
{run,whatif,gen-trace,faults,report,compare,history,compare-topology,train,obs,profile} ...``.

Counterparts of the JAX package's subcommands:

- ``run`` replays a trace (``--philly``, ``--trace`` or ``--synthetic N``
  with its knobs) on a cluster (``--cluster simple|tpu-v5e|tpu-v5p|gpu``,
  ``--chips``, ``--dims``, ``--pods``, ``--gpu-shape``; ``--placement``
  and ``--placement-seed`` choose where gangs go) under a policy
  (``--policy fifo|srtf|dlas|gandiva|optimus|themis``, ``--policy-arg
  K=V``; Optimus reads ``--curves`` and, with ``--online``, profiles each
  new model's step on ``--device``: the card unless ``--device cpu``),
  with the shared DCN fabric (``--net [SPEC]``) and injected faults
  (``--faults SPEC``) if asked, prints the summary as one JSON line and
  writes ``jobs.csv``, ``utilization.csv``, ``counters.json``,
  ``metrics.prom`` and ``metrics.json`` under ``--out``, as the JAX CLI
  does, to the byte.  Every other flag of the JAX CLI's ``run`` means
  what it means there: ``--prom``, ``--spans``, ``--sample-interval``,
  ``--sample-on-change``, ``--attrib``, ``--cache-stats``, ``--max-time``;
  ``--events [PATH]`` (the stream and its header, whose ``config_hash``
  is the JAX CLI's for the same flags) with ``--flush-events``;
  ``--perfetto``; ``--self-profile``; ``--history``; ``--snapshot`` with
  ``--snapshot-every``, and ``--resume``, which finishes a snapshot of
  this package's; ``--accounting v2``.  Their errors are the JAX CLI's.
- ``report``, ``compare`` and ``history`` read what ``run`` wrote: one
  stream's HTML report (``--json``, ``--low-mem``, ``--selfprof``,
  ``--alerts``); the two-run regression gate (exit 0 within thresholds,
  1 regressed, 2 not comparable) or the n-way matrix; the history
  store's rows and trends.  ``obs export`` turns a stream into its
  Perfetto trace.  Each writes the JAX CLI's bytes.
- ``whatif`` builds the world as ``run`` does (or restores it,
  ``--resume``), pauses it at ``--at`` and answers ``--admit``,
  ``--drain`` and ``--swap-policy`` queries by speculative forks over a
  bounded ``--horizon``, in this process or over ``--pool N`` warm
  workers; ``--out``, ``--history``, ``--prom`` and ``--trace-out`` (one
  merged Perfetto document of the fleet).  Without its latency readings
  (``canonical_document``) the document is the JAX CLI's, pooled or not.
- ``faults`` replays a Philly-like trace under each policy config of the
  eight-policy suite at one MTBF (``--events DIR``: a stream a policy),
  the JAX CLI's line, file and streams, to the byte.  The MTBF and
  contention grids are ``tools.fault_sweep`` and ``tools.net_sweep``.
- ``gen-trace`` writes a synthetic trace CSV (Poisson, or ``--philly-like``),
  the JAX CLI's file for the same flags, to the byte.
- ``compare-topology`` replays one trace on GPU clusters under their
  placement schemes and on TPU slice clusters (one pod, two pods, two pods
  on the shared fabric), prints every summary with the acceptance band
  as one JSON line and writes ``summary.json``, ``cdf_*.csv`` and
  ``report.md`` under ``--out``, as the JAX CLI does, to the byte.

- ``train`` builds a dp x sp x tp mesh and the trainer over it (``--pp``
  >= 2: a (pp, dp) mesh and the pipeline's ``PipelinedLM``, with
  ``--microbatches`` and ``--pp-schedule``), feeds it from a
  token file (``--data``, ``--data-dtype``, ``--host-shard``) or
  :func:`synthetic_lm_batches` through ``prefetch_to_device(size=2)``,
  optionally restores from (``--restore``) and saves to (``--ckpt``) a
  checkpoint, and prints one JSON summary line with the JAX CLI's keys
  (``model``, ``steps``, ``mesh``, ``first_loss``, ``last_loss``,
  ``tokens_per_s`` rounded to 0.1, ``checkpoint``, ``resumed_at_step``),
  plus ``device``.  The flags mean what they mean there, their errors
  are the same, and so is the datastream sidecar ``<ckpt>.datastream.json``
  (rank 0 writes it) with the stderr warning when a resumed run's stream
  differs from it.  With the tracer on (``GSTPU_TRACE=1``) the spans'
  summary goes to stderr as ``{"spans": ...}``.  ``--sp``, ``--tp``,
  ``--devices`` and ``--ring-attn`` mean what they mean there; the ranks
  come from the launcher (``torchrun --nproc-per-node N -m
  gpuschedule_tpu_torch train``), one a device, and rank 0 prints the
  line.  Without a launcher it runs on one device.  It trains the dense
  and MoE LMs; a CNN exits with the JAX CLI's message (image models are
  profile-only there too).
- ``profile`` measures each ``--model``'s step (any zoo model), fits its goodput curve into
  the ``--curves`` JSON that the simulator's Optimus policy reads
  (``run --policy optimus --curves``, here or in the JAX package), and prints
  ``{"model", "theta"}`` per model, then ``{"model", "trace"}`` when
  ``--trace-dir`` is given.  Under a launcher every k up to the world's
  ranks is measured on a mesh of the first k ranks (``--sp``/``--tp``
  set its replica, ``model@sp{sp}tp{tp}`` its cache key; ``--pp`` a
  pipeline's, ``model@sp1tp1pp{pp}``), and rank 0 prints and writes the
  curves.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def join_launcher_group(device) -> bool:
    """Join the process group a launcher describes (``torchrun`` sets
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and the rendezvous address):
    NCCL for cards, each rank on card ``LOCAL_RANK``, gloo for the CPU.
    Returns False when no launcher started this process."""
    from gpuschedule_tpu_torch import resolve_device

    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return True


def cmd_train(args) -> int:
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    try:
        joined = join_launcher_group(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    try:
        return _train(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _datastream_identity(args) -> dict:
    """What makes the training data stream what it is: the count-based
    resume offset is valid only when every one of these matches the
    saved run's (the JAX CLI's keys)."""
    import hashlib

    ident = {
        "seed": args.seed,
        "batch_size": args.batch_size,
        "seq_len": args.seq_len,
        "host_shard": getattr(args, "host_shard", None),
        "data": None,
    }
    if args.data and os.path.exists(args.data):
        h = hashlib.sha256()
        with open(args.data, "rb") as f:
            h.update(f.read(1 << 20))  # first MiB + size: a cheap fingerprint
        ident["data"] = {"bytes": os.path.getsize(args.data), "sha256_head": h.hexdigest()}
    return ident


def _meta_path(ckpt: str) -> Path:
    return Path(str(ckpt) + ".datastream.json")


def _write_datastream_meta(args) -> None:
    _meta_path(args.ckpt).write_text(json.dumps(_datastream_identity(args)))


def _warn_on_datastream_drift(args) -> None:
    """Compare this run's stream identity with the checkpoint's; a
    mismatch means the count-based resume would replay seen data or skip
    unseen data: warn, do not block (a dataset may be switched on
    purpose)."""
    path = _meta_path(args.restore)
    if not path.exists():
        return  # a checkpoint without a sidecar: nothing to compare
    saved = json.loads(path.read_text())
    current = _datastream_identity(args)
    drift = {k: (saved.get(k), current.get(k)) for k in current if saved.get(k) != current.get(k)}
    if drift:
        print(
            "WARNING: data stream differs from the checkpointed run "
            f"({', '.join(f'{k}: {a!r} -> {b!r}' for k, (a, b) in drift.items())}); "
            "count-based resume may replay seen data or skip unseen data",
            file=sys.stderr,
        )


def _host_shard(arg) -> "tuple[Optional[tuple[int, int]], int]":
    """``--host-shard INDEX,COUNT`` as ``(host_shard, COUNT)``; (None, 1) unset."""
    if not arg:
        return None, 1
    try:
        i, n = (int(x) for x in arg.split(","))
    except ValueError:
        raise SystemExit(f"--host-shard wants INDEX,COUNT; got {arg!r}")
    if n < 1 or not (0 <= i < n):
        raise SystemExit(f"--host-shard needs 0 <= INDEX < COUNT; got {i},{n}")
    return (i, n), n


def _train(args) -> int:
    from gpuschedule_tpu_torch.data import (
        TokenFileDataset,
        prefetch_to_device,
        synthetic_lm_batches,
    )
    from gpuschedule_tpu_torch.obs import get_tracer
    from gpuschedule_tpu_torch.parallel import PipelinedLM, ShardedTrainer, make_mesh
    from gpuschedule_tpu_torch.parallel.checkpoint import restore_state, save_state

    opt = dict(learning_rate=args.lr, flash_attn=args.flash_attn,
               warmup_steps=args.warmup_steps, decay_steps=args.decay_steps,
               grad_clip=args.grad_clip)
    if args.pp > 1 and (args.sp > 1 or args.tp > 1 or args.ring_attn):
        raise SystemExit("--pp composes with dp only; drop --sp/--tp/--ring-attn")
    try:
        if args.pp > 1:
            # the staged trainer: blocks split over pp, microbatches
            # through the pipeline's schedule
            mesh = make_mesh(pp=args.pp, devices=args.devices, device=args.device)
            trainer = PipelinedLM(args.model, mesh, batch_size=args.batch_size,
                                  seq_len=args.seq_len, num_microbatches=args.microbatches,
                                  schedule=args.pp_schedule, **opt)
        else:
            mesh = make_mesh(sp=args.sp, tp=args.tp, devices=args.devices, device=args.device)
            trainer = ShardedTrainer(args.model, mesh, batch_size=args.batch_size,
                                     seq_len=args.seq_len, seq_shard=args.ring_attn,
                                     ring_attn=args.ring_attn, **opt)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        raise SystemExit(str(e))
    if trainer.is_image:
        raise SystemExit(
            f"{args.model!r} is a CNN config; `train` feeds LM token "
            "batches (image models are profile-only for now)"
        )
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    state = restore_state(trainer, args.restore) if args.restore else trainer.init(seed=args.seed)
    # resume the data stream where the saved run left it: adamw's count is
    # the number of batches consumed, so a seeded stream restarts at it.
    # That breaks if this run changes the stream (seed, shape, file): the
    # save writes the stream's identity beside the checkpoint, and a
    # restore warns on any drift.
    resumed_at = 0
    if args.restore:
        if rank0:
            _warn_on_datastream_drift(args)
        resumed_at = state.optimizer.count()  # one read, here

    # the count is this host's batches; stream positions are global: under
    # --host-shard i,n the host consumed positions i, i+n, ..., so its next
    # global position is resumed_at * n
    host_shard, shard_n = _host_shard(args.host_shard)
    if args.data:
        ds = TokenFileDataset(
            args.data, batch_size=trainer.batch_size, seq_len=args.seq_len,
            dtype=args.data_dtype, seed=args.seed,
        )
        if ds.num_batches % shard_n:
            # unequal per-host epochs would desync the resume arithmetic
            raise SystemExit(
                f"--host-shard COUNT={shard_n} must divide the dataset's "
                f"{ds.num_batches} batches for resumable streams"
            )
        per_host_epoch = ds.num_batches // shard_n

        def batches():
            # O(1) jump to the resume position: whole epochs are in the
            # per-host count, the rest maps back to a global position
            epoch, k = divmod(resumed_at, per_host_epoch)
            start = k * shard_n
            while True:
                yield from ds.batches(epoch=epoch, start=start, host_shard=host_shard)
                epoch += 1
                start = 0
    else:
        def batches():
            yield from synthetic_lm_batches(
                batch_size=trainer.batch_size, seq_len=args.seq_len,
                vocab=trainer.cfg.vocab,
                num_batches=(resumed_at + args.steps) * shard_n,
                seed=args.seed,
                start=resumed_at * shard_n,
                host_shard=host_shard,
            )

    feed = prefetch_to_device(itertools.islice(batches(), args.steps), size=2,
                              sharding=trainer.batch_sharding)
    first_loss = None
    t0 = None
    n = 0
    loss = None
    for batch in feed:
        state, loss = trainer.step(state, batch)
        n += 1
        if first_loss is None:
            # the readback fences step 1 (kernel build, allocator warm-up);
            # the timed window starts here so tokens_per_s is warm throughput
            first_loss = float(loss)
            t0 = time.perf_counter()
    last_loss = float(loss)
    elapsed = time.perf_counter() - t0
    tokens_per_s = (
        round((n - 1) * trainer.batch_size * args.seq_len / elapsed, 1)
        if n > 1 and elapsed > 0 else None
    )
    if args.ckpt:
        save_state(state, args.ckpt)
        if rank0:
            _write_datastream_meta(args)
    if not rank0:
        return 0  # the loss is the global mean on every rank: rank 0 reports it
    dev = trainer.device
    print(json.dumps({
        "model": args.model,
        "steps": n,
        "mesh": dict(mesh.shape),
        "first_loss": first_loss,
        "last_loss": last_loss,
        "tokens_per_s": tokens_per_s,
        "checkpoint": args.ckpt or None,
        "resumed_at_step": resumed_at if args.restore else None,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }, sort_keys=True))
    if get_tracer().enabled:
        # the per-step spans aggregated, on stderr: stdout stays one line
        print(json.dumps({"spans": get_tracer().summary()}, sort_keys=True), file=sys.stderr)
    return 0


def cmd_profile(args) -> int:
    from gpuschedule_tpu_torch import resolve_device

    try:
        device = resolve_device(args.device)
        ks = tuple(int(k) for k in args.ks.split(","))
        joined = join_launcher_group(device)
    except (ValueError, RuntimeError) as e:
        raise SystemExit(str(e))
    try:
        return _profile(args, device, ks)
    finally:
        if joined:
            dist.destroy_process_group()


def _profile(args, device, ks) -> int:
    from gpuschedule_tpu_torch.profiler import CurveCache, capture_trace, profile_model

    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    cache = CurveCache(args.curves)
    for model in args.model:
        try:
            curve = profile_model(
                model, ks=ks, generation=args.generation, batch_size=args.batch_size,
                seq_len=args.seq_len, sp=args.sp, tp=args.tp, pp=args.pp, cache=cache,
                device=device,
            )
        except (ValueError, NotImplementedError) as e:
            raise SystemExit(str(e))
        if rank0:
            print(json.dumps({"model": model, "theta": list(curve.theta)}))
        if args.trace_dir:
            path = capture_trace(model, f"{args.trace_dir}/{model}", batch_size=args.batch_size,
                                 seq_len=args.seq_len, sp=args.sp, tp=args.tp, pp=args.pp,
                                 device=device)
            if rank0:
                print(json.dumps({"model": model, "trace": path}))
    return 0


def _parse_dims(raw: str) -> tuple:
    return tuple(int(x) for x in raw.lower().split("x"))


def build_cluster(args, net=None):
    from gpuschedule_tpu_torch.cluster import GpuCluster, SimpleCluster, TpuCluster
    from gpuschedule_tpu_torch.placement import with_placement

    if args.cluster == "simple":
        cluster = SimpleCluster(args.chips)
    elif args.cluster in ("tpu-v5e", "tpu-v5p"):
        gen = args.cluster.split("-")[1]
        dims = _parse_dims(args.dims) if args.dims else None
        cluster = TpuCluster(gen, dims=dims, num_pods=args.pods)
    elif args.cluster == "gpu":
        sw, npsw, gpn = _parse_dims(args.gpu_shape)
        cluster = GpuCluster(
            num_switches=sw, nodes_per_switch=npsw, gpus_per_node=gpn,
            seed=args.placement_seed,
        )
    else:
        raise SystemExit(f"unknown cluster {args.cluster!r}")
    if args.placement != "consolidated" and not isinstance(cluster, SimpleCluster):
        # with_placement validates per flavor: an unknown or mismatched
        # scheme must error, not run a different experiment than asked
        try:
            cluster = with_placement(
                cluster, args.placement, seed=args.placement_seed, net=net
            )
        except ValueError as e:
            raise SystemExit(str(e)) from None
    return cluster


def build_net(args):
    """The shared-fabric contention model for ``run --net`` (None when the
    flag is absent: the static-factor path)."""
    if not getattr(args, "net", None):
        return None
    if args.cluster not in ("tpu-v5e", "tpu-v5p"):
        raise SystemExit(
            "--net models the TPU DCN fabric; use --cluster tpu-v5e/tpu-v5p"
        )
    from gpuschedule_tpu_torch.net import NetConfig, NetModel, parse_net_spec

    try:
        config = (
            parse_net_spec(args.net) if isinstance(args.net, str) else NetConfig()
        )
    except ValueError as e:
        raise SystemExit(str(e)) from None
    return NetModel(config)


def build_fault_plan(args, cluster, jobs):
    """Fault injection (faults/): one ``--seed`` governs every stochastic
    stream in the run.  Trace synthesis keeps the bare seed, while each
    fault process derives its own ``random.Random(f"{seed}:faults:<process>")``
    stream, so the same seed reproduces the trace and the fault schedule
    together, and changing the fault config never perturbs the trace (the
    seed-split rule, in faults/schedule.py)."""
    if not args.faults:
        return None
    from gpuschedule_tpu_torch.faults import (
        fault_horizon,
        make_fault_plan,
        parse_fault_spec,
    )

    try:
        fconfig, frecovery = parse_fault_spec(args.faults)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    horizon = args.max_time if args.max_time else fault_horizon(jobs)
    try:
        return make_fault_plan(
            cluster, fconfig, frecovery, horizon=horizon, seed=args.seed
        )
    except ValueError as e:
        # config-vs-cluster mismatches (a domain weight naming a level
        # this topology has no domains for) are user errors
        raise SystemExit(str(e)) from None


def load_jobs(args) -> list:
    from gpuschedule_tpu_torch.sim.philly import load_philly_csv
    from gpuschedule_tpu_torch.sim.trace import generate_poisson_trace, load_trace_csv

    if args.philly:
        return load_philly_csv(args.philly, max_chips=args.max_job_chips)
    if args.trace:
        return load_trace_csv(args.trace)
    if args.synthetic:
        return generate_poisson_trace(
            args.synthetic,
            seed=args.seed,
            arrival_rate=args.arrival_rate,
            mean_duration=args.mean_duration,
            failure_rate=args.failure_rate,
            util_range=(args.util_min, 1.0),
        )
    raise SystemExit("provide one of --philly / --trace / --synthetic N")


def _parse_policy_kwargs(pairs) -> dict:
    kwargs = {}
    for kv in pairs or []:
        k, _, v = kv.partition("=")
        try:
            parsed = json.loads(v)
        except json.JSONDecodeError:
            parsed = v
        kwargs[k.replace("-", "_")] = parsed
    return kwargs


def build_policy(args):
    """The policy ``run`` schedules with: the JAX CLI's, and Optimus
    measures on ``--device`` (the card unless ``--device cpu``)."""
    from gpuschedule_tpu_torch.policies import make_policy

    kwargs = _parse_policy_kwargs(args.policy_arg)
    if args.policy == "optimus":
        if args.curves:
            from gpuschedule_tpu_torch.profiler import CurveCache

            kwargs.setdefault("curve_cache", CurveCache(args.curves))
            if args.online:
                kwargs.setdefault("online", True)
        if kwargs.get("online"):
            from gpuschedule_tpu_torch import resolve_device

            # no card and no --device cpu: refuse before the replay starts
            try:
                kwargs.setdefault("device", resolve_device(args.device))
            except (RuntimeError, ValueError) as e:
                raise SystemExit(str(e)) from None
    return make_policy(args.policy, **kwargs)


def _run_config_hash(args) -> str:
    """Digest of the *experiment* config — cluster + trace + fault spec,
    deliberately not the policy — so `compare` accepts policy-A-vs-B runs
    of the same seeded world and refuses cross-world diffs.  The flag ->
    hash-key mapping lives in ONE table (``worldspec.py``), the JAX
    package's, so a run's hash equals the JAX CLI's for the same flags."""
    from gpuschedule_tpu_torch import worldspec
    from gpuschedule_tpu_torch.obs import config_hash

    return config_hash(worldspec.hash_config(args))


def _append_run_history(store_path, run_meta, summary, *, policy, seed,
                        fallback_hash) -> None:
    """One history row for a finished replay, keyed by its run identity.
    Shared by fresh and resumed runs so the row shape cannot drift
    between the two paths."""
    from gpuschedule_tpu_torch.obs import HistoryStore

    chash = run_meta["config_hash"] if run_meta else fallback_hash
    with HistoryStore(store_path) as store:
        store.append(
            "run",
            run_id=(run_meta["run_id"] if run_meta
                    else f"{policy}-s{seed}-{chash}"),
            config_hash=chash,
            policy=policy,
            seed=seed,
            metrics=summary,
        )


def _cmd_resume(args) -> int:
    """``run --resume SNAPSHOT``: reconstruct a mid-replay engine from a
    ``--snapshot`` file and finish it.  World-building flags (--philly /
    --synthetic / --cluster / --faults / --net ...) are ignored — the
    snapshot IS the world; output flags (--out / --events / --prefix),
    --history / --cache-stats, and the snapshot/self-profile knobs still
    apply.  --perfetto / --prom / --spans are refused (their collectors
    are process-bound and cannot cover the pre-snapshot head).  Under v1
    accounting the finished outputs are byte-identical to the
    uninterrupted run (the obs registry / metrics.prom is process-bound
    and counts only the tail — the one documented exception)."""
    import math

    from gpuschedule_tpu_torch.sim import Simulator
    from gpuschedule_tpu_torch.sim.snapshot import SnapshotError

    if args.events is True and not args.out:
        raise SystemExit("--events without a PATH requires --out")
    if bool(args.snapshot) != bool(args.snapshot_every):
        raise SystemExit("--snapshot PATH and --snapshot-every SECONDS arm together")
    if args.snapshot_every is not None and not (
            math.isfinite(float(args.snapshot_every))
            and float(args.snapshot_every) > 0.0):
        # the fresh-run path gets this from the Simulator constructor;
        # the resume re-arm pokes the fields directly, so check here
        raise SystemExit(
            f"--snapshot-every must be > 0 seconds, got {args.snapshot_every}"
        )
    for armed, name in ((args.perfetto, "--perfetto"), (args.prom, "--prom"),
                        (args.spans, "--spans")):
        if armed:
            raise SystemExit(f"{name} is not supported with --resume")
    events_sink = None
    if isinstance(args.events, str):
        events_sink = Path(args.events)
    elif args.events:
        events_sink = Path(args.out) / f"{args.prefix}events.jsonl"
    profiler = None
    if args.self_profile:
        from gpuschedule_tpu_torch.obs import PhaseProfiler

        profiler = PhaseProfiler()
    try:
        sim = Simulator.restore(
            args.resume, events_sink=events_sink, profiler=profiler
        )
    except SnapshotError as e:
        raise SystemExit(str(e)) from None
    if args.snapshot and args.snapshot_every:
        # re-arm (or move) periodic snapshotting for the resumed leg:
        # next strict multiple of the cadence past the restored clock
        every = float(args.snapshot_every)
        sim._snap_path = Path(args.snapshot)
        sim._snap_every = every
        nxt = every * (math.floor(sim.now / every) + 1.0)
        while nxt <= sim.now:  # float-rounding guard
            nxt += every
        sim._snap_next = nxt
    if args.cache_stats:
        # arm (or re-arm) cache telemetry for the resumed leg: restored
        # caches start empty, so the counters cover exactly the tail —
        # the same process-bound scope as the obs registry exception
        sim.metrics.cache_telemetry = True
        sim._cache_telemetry = True
    if args.flush_events is not None:
        # re-arm the tailable-sink flush cadence: the cadence is
        # process-bound output plumbing (like the sink handle itself,
        # deliberately not in the snapshot), so the resumed leg must
        # re-request it — next strict multiple past the restored clock
        if args.flush_events <= 0.0:
            raise SystemExit(
                f"--flush-events must be > 0 seconds, got {args.flush_events}"
            )
        fe = float(args.flush_events)
        sim.metrics._flush_every = fe
        nxt = fe * (math.floor(sim.now / fe) + 1.0)
        while nxt <= sim.now:  # float-rounding guard
            nxt += fe
        sim.metrics._flush_next = nxt
    with sim.metrics:
        res = sim.run()
    print(json.dumps(res.summary(), sort_keys=True))
    if profiler is not None:
        profiler.write(args.self_profile)
    if args.history:
        # the resumed leg appends its summary under the pickled run
        # identity, as the uninterrupted run would have
        rm = sim.metrics.run_meta
        _append_run_history(
            args.history, rm, res.summary(),
            policy=(rm or {}).get("policy", args.policy),
            seed=(rm or {}).get("seed", args.seed),
            fallback_hash="resumed",
        )
    if args.out:
        sim.metrics.write(args.out, prefix=args.prefix)
    else:
        sim.metrics.close_events()
    return 0


def cmd_run(args) -> int:
    from gpuschedule_tpu_torch.sim import Simulator
    from gpuschedule_tpu_torch.sim.metrics import MetricsLog

    if args.resume:
        return _cmd_resume(args)
    # --events PATH captures anywhere; bare --events writes events.jsonl
    # under --out
    if args.events is True and not args.out:
        raise SystemExit("--events without a PATH requires --out")
    from gpuschedule_tpu_torch.obs import get_tracer

    # --spans enables the tracer; GSTPU_TRACE=1 enables it at import.  Either
    # way an enabled tracer gets its spans reported below.
    if args.spans:
        get_tracer().enable().reset()
    tracer = get_tracer() if get_tracer().enabled else None
    registry = None
    if args.out or args.prom:
        from gpuschedule_tpu_torch.obs import MetricsRegistry

        registry = MetricsRegistry()
    net_model = build_net(args)
    if args.placement == "contention" and net_model is None:
        # without the net model every pod scores equally and the scheme
        # would quietly become consolidated: refuse
        raise SystemExit(
            "--placement contention scores pods by residual DCN bandwidth "
            "and needs the fabric model: add --net"
        )
    cluster = build_cluster(args, net=net_model)
    jobs = load_jobs(args)
    fault_plan = build_fault_plan(args, cluster, jobs)
    # With --events the stream goes straight to its JSONL sink (constant
    # memory at Philly scale): to the given PATH, or events.jsonl under
    # --out for the bare flag; --perfetto alone buffers events in RAM just
    # long enough to convert them.
    if isinstance(args.events, str):
        events_sink = Path(args.events)
    elif args.events:
        events_sink = Path(args.out) / f"{args.prefix}events.jsonl"
    else:
        events_sink = None
    # Stream identity header (obs/analyze.py): stamped whenever events are
    # recorded so `report`/`compare` can verify what they are reading.
    run_meta = None
    if events_sink is not None or args.perfetto:
        chash = _run_config_hash(args)
        run_meta = {
            "run_id": f"{args.policy}-s{args.seed}-{chash}",
            "seed": args.seed, "policy": args.policy, "config_hash": chash,
        }
    if args.sample_interval is not None and args.sample_interval <= 0.0:
        raise SystemExit(
            f"--sample-interval must be > 0 seconds, got {args.sample_interval}"
        )
    if args.flush_events is not None and args.flush_events <= 0.0:
        raise SystemExit(
            f"--flush-events must be > 0 seconds, got {args.flush_events}"
        )
    # Attribution and sampling are observability, not experiment config:
    # they are not in the config hash, so an attribution-armed capture
    # stays `compare`-compatible with the plain run of the same world.
    metrics = MetricsLog(
        record_events=bool(args.events) or bool(args.perfetto),
        events_sink=events_sink,
        registry=registry,
        run_meta=run_meta,
        attribution=bool(args.attrib),
        cache_telemetry=bool(args.cache_stats),
        flush_interval_s=args.flush_events,
    )
    # --self-profile attaches the phase profiler and selects the engine's
    # profiled loop body; the flag off, no clock is ever read.
    profiler = None
    if args.self_profile:
        from gpuschedule_tpu_torch.obs import PhaseProfiler

        profiler = PhaseProfiler()
    if bool(args.snapshot) != bool(args.snapshot_every):
        raise SystemExit("--snapshot PATH and --snapshot-every SECONDS arm together")
    try:
        sim = Simulator(
            cluster, build_policy(args), jobs,
            metrics=metrics,
            max_time=args.max_time or float("inf"),
            faults=fault_plan,
            net=net_model,
            sample_interval=args.sample_interval,
            sample_on_change=bool(args.sample_on_change),
            profiler=profiler,
            accounting=args.accounting,
            snapshot_every=args.snapshot_every,
            snapshot_path=Path(args.snapshot) if args.snapshot else None,
        )
    except ValueError as e:
        raise SystemExit(str(e)) from None
    # context-manager path: an engine exception still flushes/closes the
    # JSONL sink, leaving an analyzable stream behind
    with metrics:
        res = sim.run()
    print(json.dumps(res.summary(), sort_keys=True))
    if profiler is not None:
        profiler.meta.update({
            "seed": args.seed,
            **({"run_id": run_meta["run_id"],
                "config_hash": run_meta["config_hash"]}
               if run_meta is not None else {}),
        })
        profiler.write(args.self_profile)
        print(json.dumps(
            {"selfprof": str(args.self_profile),
             "total_wall_s": profiler.total_wall_s,
             "batches": profiler.batches},
            sort_keys=True), file=sys.stderr)
    if args.history:
        # append this invocation's summary keyed by run identity, so
        # `history trend` can render the trajectory across invocations
        _append_run_history(
            args.history, run_meta, res.summary(),
            policy=args.policy, seed=args.seed,
            fallback_hash=(None if run_meta else _run_config_hash(args)),
        )
    if args.out:
        sim.metrics.write(args.out, prefix=args.prefix)
    else:
        metrics.close_events()
    if args.perfetto:
        from gpuschedule_tpu_torch.obs import export_chrome_trace, load_events_jsonl

        events = (
            load_events_jsonl(events_sink) if events_sink is not None
            else metrics.events
        )
        export_chrome_trace(events, args.perfetto)
    if registry is not None:
        if args.prom:
            registry.write(prom_path=args.prom)
        if args.out:
            registry.write(
                prom_path=Path(args.out) / f"{args.prefix}metrics.prom",
                json_path=Path(args.out) / f"{args.prefix}metrics.json",
            )
    if tracer is not None:
        if args.out:
            tracer.write_chrome(Path(args.out) / f"{args.prefix}spans.trace.json")
        print(json.dumps({"spans": tracer.summary()}, sort_keys=True), file=sys.stderr)
    return 0


def cmd_obs_export(args) -> int:
    """Convert a persisted events.jsonl into a ui.perfetto.dev-loadable
    Chrome trace-event file (the offline half of `run --perfetto`)."""
    from gpuschedule_tpu_torch.obs import export_chrome_trace, load_events_jsonl

    doc = export_chrome_trace(load_events_jsonl(args.events), args.out)
    print(json.dumps({
        "trace": str(args.out),
        "trace_events": len(doc["traceEvents"]),
    }, sort_keys=True))
    return 0


def cmd_report(args) -> int:
    """Render one run's events.jsonl as a self-contained HTML report
    (inline CSS/SVG, zero network fetches) — the human half of the
    analytics layer; `compare` is the CI half."""
    from gpuschedule_tpu_torch.obs import SchemaError, StreamError, analyze_file, write_report

    selfprof = None
    if args.selfprof:
        from gpuschedule_tpu_torch.obs import load_profile

        try:
            selfprof = load_profile(args.selfprof)
        except (OSError, ValueError) as e:
            raise SystemExit(str(e)) from None
    alerts = None
    if args.alerts:
        # the watchtower's side stream: skip its header, keep the alert
        # records — the report's Alerts panel input
        from gpuschedule_tpu_torch.obs import iter_jsonl_records

        try:
            alerts = [
                rec for rec in iter_jsonl_records(args.alerts)
                if rec.get("event") == "alert"
            ]
        except StreamError as e:
            raise SystemExit(str(e)) from None
    try:
        analysis = analyze_file(args.events, require_header=not args.no_header,
                                low_memory=args.low_mem)
    except (SchemaError, StreamError) as e:
        raise SystemExit(str(e)) from None
    out = write_report(analysis, args.out, title=args.title, selfprof=selfprof,
                       alerts=alerts)
    if args.json:
        if args.low_mem:
            # spill-backed JSON dump: stream the jobs array straight from
            # the sqlite store, resident memory O(active); its means may
            # differ from the in-memory document's in their last digits
            # (ROADMAP.md Queue 3, as in the JAX package)
            analysis.write_json(args.json)
        else:
            Path(args.json).write_text(
                json.dumps(analysis.to_json(), indent=2, sort_keys=True)
            )
    print(json.dumps({
        "report": str(out),
        "events": analysis.num_events,
        "jobs": len(analysis.jobs),
        "max_progress_drift": analysis.max_progress_drift,
    }, sort_keys=True))
    return 0


def cmd_compare(args) -> int:
    """Regression-diff event streams for CI gating.

    Two streams: the gate — exit 0 when B stays within threshold of A on
    every gated metric, 1 past any threshold, 2 when the runs are not
    comparable (missing or mismatched headers).  Three or more: the
    n-way policy x metric matrix with per-metric best/worst highlighting
    (exit 0, or 2 when any pair is not comparable; thresholds apply only
    to the two-run gate)."""
    from gpuschedule_tpu_torch.obs import (
        SchemaError,
        StreamError,
        analyze_file,
        compare_matrix,
        compare_runs,
        parse_thresholds,
        write_compare_json,
        write_matrix_json,
    )

    try:
        default, per_metric = parse_thresholds(args.threshold)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if len(args.streams) < 2:
        # usage error, not a regression: exit 2 (the not-comparable
        # bucket) so a CI glob matching one file doesn't read as exit-1
        # "metric regressed"
        print("compare needs at least two event streams", file=sys.stderr)
        return 2
    if len(args.streams) > 2 and args.threshold:
        print(
            "--threshold gates the two-run compare; the n-way matrix "
            "ranks, it does not gate",
            file=sys.stderr,
        )
        return 2
    try:
        analyses = [
            analyze_file(path, low_memory=args.low_mem)
            for path in args.streams
        ]
        if len(analyses) == 2:
            result = compare_runs(
                analyses[0], analyses[1],
                threshold=default, per_metric=per_metric,
                allow_mismatch=args.allow_mismatch,
            )
        else:
            result = compare_matrix(
                analyses, allow_mismatch=args.allow_mismatch
            )
    except (SchemaError, StreamError) as e:
        print(f"refusing to compare: {e}", file=sys.stderr)
        return 2
    print(result.format_table())
    if args.json:
        if len(analyses) == 2:
            write_compare_json(result, args.json)
        else:
            write_matrix_json(result, args.json)
    if args.history:
        # every compared stream's summary lands in the store under its
        # own header identity, so repeated compare invocations
        # accumulate per-config trajectories that `history trend` renders
        from gpuschedule_tpu_torch.obs import HistoryStore

        with HistoryStore(args.history) as store:
            for a in analyses:
                h = a.header
                store.append(
                    "compare",
                    run_id=h.run_id if h else "",
                    config_hash=h.config_hash if h else "",
                    policy=h.policy if h else "",
                    seed=h.seed if h else None,
                    metrics=a.summary(),
                )
    return result.exit_code if len(analyses) == 2 else 0


def cmd_history(args) -> int:
    """Cross-run history: render the store's accumulated run/compare/bench
    results.  ``trend`` prints a deterministic per-metric trajectory
    table (same store -> same bytes, however many times it is invoked);
    ``list`` prints the matching rows."""
    from gpuschedule_tpu_torch.obs import HistoryStore, render_trend

    if not Path(args.store).exists():
        raise SystemExit(f"history store {args.store} does not exist")
    with HistoryStore(args.store) as store:
        rows = store.rows(
            kind=args.kind, config_hash=args.config, label=args.label,
            last=args.last,
        )
    if args.action == "list":
        for r in rows:
            print(json.dumps({
                "seq": r.seq, "kind": r.kind, "run_id": r.run_id,
                "config_hash": r.config_hash, "policy": r.policy,
                "seed": r.seed, "label": r.label,
            }, sort_keys=True))
        print(f"{len(rows)} rows", file=sys.stderr)
    else:
        metrics = args.metric or ["avg_jct"]
        print(render_trend(rows, metrics))
    if args.json:
        Path(args.json).write_text(json.dumps(
            [{
                "seq": r.seq, "ts": r.ts, "kind": r.kind,
                "run_id": r.run_id, "config_hash": r.config_hash,
                "policy": r.policy, "seed": r.seed, "label": r.label,
                "metrics": r.metrics,
            } for r in rows],
            indent=2, sort_keys=True,
        ))
    return 0


def cmd_faults(args) -> int:
    """Fault-injection demo: one seeded chaos replay (Philly-like trace,
    finite MTBF) per policy config, reporting the goodput decomposition —
    which policies degrade gracefully as hardware gets flakier.

    ``tools.fault_sweep`` is the full MTBF x policy grid; this subcommand
    is its single-MTBF slice, small enough to eyeball.  The line, the
    ``--out`` file and the ``--events`` streams are the JAX CLI's bytes.
    """
    from gpuschedule_tpu_torch.faults.sweep import POLICY_CONFIGS, jsonable, run_cell

    keys = args.policies.split(",") if args.policies else list(POLICY_CONFIGS)
    unknown = [k for k in keys if k not in POLICY_CONFIGS]
    if unknown:
        raise SystemExit(
            f"unknown policy configs {unknown}; known: {sorted(POLICY_CONFIGS)}"
        )
    if args.restore == "auto":
        restore: object = "auto"
    else:
        try:
            restore = float(args.restore)
        except ValueError:
            raise SystemExit(
                f"--restore wants seconds or 'auto', got {args.restore!r}"
            ) from None
    events_dir = None
    if args.events:
        events_dir = Path(args.events)
        events_dir.mkdir(parents=True, exist_ok=True)
    cells = [
        run_cell(
            k,
            mtbf=args.mtbf,
            repair=args.repair,
            ckpt=args.ckpt,
            restore=restore,
            num_jobs=args.num_jobs,
            seed=args.seed,
            dims=_parse_dims(args.dims),
            num_pods=args.pods,
            max_time=args.max_time,
            events_path=(
                events_dir / f"{k}.events.jsonl" if events_dir else None
            ),
        )
        for k in keys
    ]
    doc = jsonable({  # --mtbf inf must stay strict JSON ("inf", not Infinity)
        "mtbf_s": args.mtbf,
        "repair_s": args.repair,
        "ckpt_s": args.ckpt,
        "seed": args.seed,
        "num_jobs": args.num_jobs,
        "cells": cells,
    })
    print(json.dumps(doc, sort_keys=True))
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(doc, indent=2, sort_keys=True))
    return 0


def cmd_whatif(args) -> int:
    """Interactive what-if queries against a mirrored replay:
    build the world exactly like ``run``, advance the engine to ``--at``
    and pause it there — a live mirror of cluster state — then answer
    admit / drain / policy-swap queries by speculative forks (optionally
    across a persistent worker pool), each returning the attributed
    delta against a mutation-free baseline fork of the same bounded
    horizon.  For the same flags, the canonical result document
    (:func:`canonical_document`: without the latency readings), the
    history rows and the ``--prom`` families are the JAX CLI's, but for
    the wall-clock readings (latency, time stamps)."""
    from gpuschedule_tpu_torch.obs import MetricsRegistry
    from gpuschedule_tpu_torch.sim import Simulator
    from gpuschedule_tpu_torch.sim.metrics import MetricsLog
    from gpuschedule_tpu_torch.sim.whatif import (
        WhatIfService,
        append_history,
        parse_admit_spec,
        parse_drain_spec,
        result_document,
    )

    queries = []
    try:
        for spec in args.admit or []:
            queries.extend(parse_admit_spec(spec))
        for spec in args.drain or []:
            queries.append(parse_drain_spec(spec))
    except ValueError as e:
        raise SystemExit(str(e)) from None
    for name in args.swap_policy or []:
        queries.append({"kind": "policy-swap", "policy": name})
    if not queries:
        raise SystemExit(
            "whatif needs at least one --admit / --drain / --swap-policy "
            "query"
        )
    if args.at < 0.0:
        raise SystemExit(f"--at must be >= 0, got {args.at}")
    if args.resume:
        # flight-recorder handshake: mirror from a pinned
        # engine snapshot (`watch --flight-dir` + `run --snapshot`)
        # instead of rebuilding the world — world-building flags are
        # ignored, the snapshot IS the world.  The mirror must never
        # write into (or truncate!) the watched run's event stream, so
        # the sink is detached and recording disarmed.
        from gpuschedule_tpu_torch.sim.snapshot import SnapshotError

        try:
            sim = Simulator.restore(args.resume, events_sink=False)
        except SnapshotError as e:
            raise SystemExit(str(e)) from None
        sim.metrics.record_events = False
        sim.metrics.events = []
        sim._snap_path = None
        sim._snap_every = None
        sim._snap_next = float("inf")
        # the snapshotted run's --max-time was an output-capture cutoff,
        # not a property of the world: speculating past the incident is
        # the whole point, so the mirror's bound is --horizon (and an
        # explicit --max-time on THIS invocation, when given)
        sim.max_time = args.max_time or float("inf")
        if args.at < sim.now:
            raise SystemExit(
                f"--at {args.at} is before the snapshot instant "
                f"(t={sim.now}); pin an earlier snapshot"
            )
    else:
        net_model = build_net(args)
        if args.placement == "contention" and net_model is None:
            raise SystemExit(
                "--placement contention scores pods by residual DCN "
                "bandwidth and needs the fabric model: add --net"
            )
        cluster = build_cluster(args, net=net_model)
        jobs = load_jobs(args)
        fault_plan = build_fault_plan(args, cluster, jobs)
        # the mirror runs with attribution armed so every speculative
        # delta decomposes by cause (the attribution machinery); whatif has no
        # byte-compat surface of its own to preserve
        metrics = MetricsLog(attribution=True)
        try:
            sim = Simulator(
                cluster, build_policy(args), jobs,
                metrics=metrics,
                max_time=args.max_time or float("inf"),
                faults=fault_plan,
                net=net_model,
                accounting=args.accounting,
            )
        except ValueError as e:
            raise SystemExit(str(e)) from None
    sim.run_until(args.at)
    # deterministic user errors must exit cleanly BEFORE evaluation — a
    # pooled worker would otherwise retry them with backoff and surface
    # a raw traceback
    for q in queries:
        at = q.get("at")
        if at is None:
            continue
        if at < sim.now:
            raise SystemExit(
                f"query at={at} is before the mirror instant "
                f"(the engine paused at t={sim.now}); speculative "
                "mutations cannot land in the replayed past"
            )
        if at > min(sim.now + args.horizon, sim.max_time):
            raise SystemExit(
                f"query at={at} is beyond the bounded replay window "
                f"(mirror t={sim.now} + horizon {args.horizon}, capped "
                f"by --max-time {sim.max_time}); it would never be "
                "applied — raise --horizon or move it earlier"
            )
    if args.resume:
        # the mirror's identity is the snapshotted run's, not the
        # (ignored) world flags'
        rm = sim.metrics.run_meta or {}
        chash = str(rm.get("config_hash") or "resumed")
        run_meta = {
            "run_id": str(rm.get("run_id") or f"resumed-{sim.policy.name}"),
            "seed": rm.get("seed"), "policy": sim.policy.name,
            "config_hash": chash,
        }
    else:
        chash = _run_config_hash(args)
        run_meta = {
            "run_id": f"{args.policy}-s{args.seed}-{chash}",
            "seed": args.seed, "policy": args.policy, "config_hash": chash,
        }
    registry = MetricsRegistry()
    fleet = None
    if args.trace_out:
        # arm cross-process tracing — the run_id is the trace
        # id every worker span links back to
        from gpuschedule_tpu_torch.obs import FleetCollector

        fleet = FleetCollector(run_meta["run_id"], parent="whatif")
    try:
        service = WhatIfService(
            sim, horizon=args.horizon, workers=args.pool, registry=registry,
            fleet=fleet,
        )
    except ValueError as e:
        raise SystemExit(str(e)) from None
    pool_stats = None
    try:
        results = service.evaluate(queries)
        pool_stats = service.pool_stats()
    except ValueError as e:
        # belt and braces: any remaining deterministic query error (the
        # evaluator re-validates against the fork's actual bound) is a
        # user error, not a traceback
        raise SystemExit(str(e)) from None
    finally:
        service.close()
    doc = result_document(
        sim, results, requested_at=args.at, horizon=args.horizon,
        pool=args.pool, run_meta=run_meta,
    )
    print(json.dumps(doc, sort_keys=True))
    if args.history:
        # pool_stats() answers in serial mode too (for /status); the
        # extra history "pool" row stays pool-only
        n = append_history(args.history, results, run_meta=run_meta,
                           pool_stats=pool_stats if args.pool else None)
        print(f"{n} whatif history rows -> {args.history}", file=sys.stderr)
    if args.out:
        out = Path(args.out)
        if out.parent and not out.parent.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(doc, indent=2, sort_keys=True))
    if fleet is not None:
        # parent-side families (query latency, pool lifecycle) join the
        # merged document FIRST; the federated worker families then fold
        # into the --prom registry (this order, or worker counters would
        # double-count in the document)
        fleet.registry.merge(registry)
        tdoc = fleet.write(args.trace_out)
        print(
            f"fleet trace ({tdoc['federation']['tasks']} tasks, "
            f"{len(tdoc['federation']['workers'])} workers) -> "
            f"{args.trace_out}",
            file=sys.stderr,
        )
        fleet.merge_into(registry)
    if args.prom:
        registry.write(prom_path=args.prom)
    return 0


def cmd_gen_trace(args) -> int:
    from gpuschedule_tpu_torch.sim.philly import (
        PHILLY_MEAN_INTERARRIVAL_S,
        generate_philly_like_trace,
        save_philly_csv,
    )
    from gpuschedule_tpu_torch.sim.trace import generate_poisson_trace, save_trace_csv

    if args.philly_like:
        rate = (args.arrival_rate if args.arrival_rate is not None
                else 1.0 / PHILLY_MEAN_INTERARRIVAL_S)
        jobs = generate_philly_like_trace(args.num_jobs, seed=args.seed, arrival_rate=rate)
        save_philly_csv(jobs, args.out)
    else:
        rate = args.arrival_rate if args.arrival_rate is not None else 1.0 / 60.0
        jobs = generate_poisson_trace(
            args.num_jobs,
            seed=args.seed,
            arrival_rate=rate,
            mean_duration=args.mean_duration,
            failure_rate=args.failure_rate,
            util_range=(args.util_min, 1.0),
        )
        save_trace_csv(jobs, args.out)
    print(f"wrote {len(jobs)} jobs to {args.out}")
    return 0


def cmd_compare_topology(args) -> int:
    """The topology comparison: NVLink GPU nodes against contiguous TPU
    slices.

    Computes the acceptance band (the TPU-v5p replay's avg-JCT and makespan
    delta against the GPU baseline under the consolidated scheme, on the
    same trace) and averages the random scheme over ``--seeds`` draws, so
    that the GPU-against-TPU contrast is not a single sample.
    """
    from statistics import mean

    from gpuschedule_tpu_torch.analysis import acceptance_band, write_report
    from gpuschedule_tpu_torch.cluster import GpuCluster, TpuCluster
    from gpuschedule_tpu_torch.net import NetModel
    from gpuschedule_tpu_torch.policies import make_policy
    from gpuschedule_tpu_torch.sim import Simulator
    from gpuschedule_tpu_torch.sim.philly import load_philly_csv
    from gpuschedule_tpu_torch.sim.trace import generate_poisson_trace

    def jobs(num_pods: int = 1):
        if args.philly:
            # multi-pod configs keep the trace's whales as multislice
            # gangs instead of clamping them to one pod
            return load_philly_csv(args.philly, num_pods=num_pods)
        return generate_poisson_trace(args.synthetic or 200, seed=args.seed)

    gpu_shape = _parse_dims(args.gpu_shape)

    def gpu(scheme: str, seed: int = 0) -> GpuCluster:
        return GpuCluster(
            num_switches=gpu_shape[0], nodes_per_switch=gpu_shape[1],
            gpus_per_node=gpu_shape[2], scheme=scheme, seed=seed)

    configs = {"gpu-consolidated": gpu("consolidated")}
    for s in range(max(1, args.seeds)):
        configs[f"gpu-random-s{s}"] = gpu("random", seed=s)
    configs.update({
        "gpu-topology": gpu("topology"),
        "tpu-v5p": TpuCluster("v5p"),
        "tpu-v5e": TpuCluster("v5e"),
        # the ICI-against-DCN boundary: the same generation, two pods
        # joined by DCN, whales run as multislice gangs at a speed_factor
        # < 1 instead of being clamped into one pod
        "tpu-v5p-2pod": TpuCluster("v5p", num_pods=2),
    })
    pods_of = {"tpu-v5p-2pod": 2}
    pol_kwargs = _parse_policy_kwargs(args.policy_arg)
    results = {}
    for name, cluster in configs.items():
        results[name] = Simulator(
            cluster, make_policy(args.policy, **pol_kwargs),
            jobs(pods_of.get(name, 1)),
        ).run()

    # contention column: the 2-pod fleet again with the shared-fabric
    # model on, whales paying a max-min fair share of the DCN instead of
    # each assuming an isolated fabric.  The ratio against the static
    # 2-pod replay is the shared-fabric penalty under the default 4:1
    # core oversubscription; mean link utilization says how loaded it was.
    net_model = NetModel()
    results["tpu-v5p-2pod-net"] = Simulator(
        TpuCluster("v5p", num_pods=2), make_policy(args.policy, **pol_kwargs),
        jobs(2), net=net_model,
    ).run()

    rand = [results[k] for k in results if k.startswith("gpu-random-s")]
    # how many gangs spanned pods in the 2-pod replay: with none, the
    # 2-pod/1-pod JCT ratio says nothing about DCN (only doubled
    # capacity), so the ratio is reported with its multislice count and
    # nulled when no gang crossed a pod
    pod_chips = configs["tpu-v5p-2pod"].pod_chips
    n_multislice = sum(1 for j in jobs(2) if j.num_chips > pod_chips)
    extra = {
        "acceptance": acceptance_band(results["gpu-consolidated"], results["tpu-v5p"]),
        "gpu-random-mean": {
            "avg_jct": mean(r.avg_jct for r in rand),
            "makespan": mean(r.makespan for r in rand),
            "seeds": len(rand),
        },
        "dcn_vs_ici": {
            "multislice_jobs": n_multislice,
            "jct_ratio_2pod_over_1pod": (
                results["tpu-v5p-2pod"].avg_jct / results["tpu-v5p"].avg_jct
                if n_multislice else None
            ),
        },
        "contention": {
            "multislice_jobs": n_multislice,
            "oversubscription": net_model.config.oversubscription,
            "jct_ratio_net_over_static": (
                results["tpu-v5p-2pod-net"].avg_jct
                / results["tpu-v5p-2pod"].avg_jct
                if n_multislice and results["tpu-v5p-2pod"].avg_jct > 0
                else None
            ),
            "net_reprices": int(
                results["tpu-v5p-2pod-net"].counters.get("net_reprices", 0)
            ),
            "mean_link_utilization": net_model.mean_utilization(),
        },
    }
    if args.load_sweep:
        # the acceptance band against offered load; the base-load point
        # reuses the replays already computed above
        from gpuschedule_tpu_torch.analysis import acceptance_load_sweep

        extra["load_sweep"] = acceptance_load_sweep(
            jobs,
            lambda: gpu("consolidated"),
            lambda: TpuCluster("v5p"),
            lambda: make_policy(args.policy, **pol_kwargs),
            base_results=(results["gpu-consolidated"], results["tpu-v5p"]),
        )
    out = {k: v.summary() for k, v in results.items()}
    out.update(extra)
    print(json.dumps(out, sort_keys=True))
    if args.out:
        write_report(results, args.out, extra=extra)
    return 0


def _add_world_args(p) -> None:
    """The JAX CLI's world-building flags that this package's modules
    serve (``gpuschedule_tpu/cli.py:_add_world_args``), with their
    defaults.  Choices the port has not yet are out of the choices."""
    from gpuschedule_tpu_torch.policies import available

    p.add_argument("--policy", choices=available(), default="fifo")
    p.add_argument("--policy-arg", action="append", metavar="K=V",
                   help="policy constructor kwarg (JSON values)")
    p.add_argument("--cluster", default="tpu-v5e",
                   choices=("simple", "tpu-v5e", "tpu-v5p", "gpu"))
    p.add_argument("--chips", type=int, default=64, help="simple cluster size")
    p.add_argument("--dims", help="TPU pod dims, e.g. 16x16 / 8x8x4")
    p.add_argument("--pods", type=int, default=1)
    p.add_argument("--gpu-shape", default="2x4x8",
                   help="switches x nodes x gpus for --cluster gpu")
    p.add_argument("--placement", default="consolidated",
                   help="consolidated|random|greedy|topology (gpu) / "
                        "consolidated|random|spread|contention|health "
                        "(tpu; contention needs --net, health steers "
                        "away from degraded/high-hazard chips)")
    p.add_argument("--placement-seed", type=int, default=0)
    p.add_argument("--philly", help="Philly-schema trace CSV")
    p.add_argument("--trace", help="native-schema trace CSV")
    p.add_argument("--synthetic", type=int, metavar="N", help="generate N-job Poisson trace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--arrival-rate", type=float, default=1.0 / 60.0)
    p.add_argument("--mean-duration", type=float, default=3600.0)
    p.add_argument("--failure-rate", type=float, default=0.0)
    p.add_argument("--util-min", type=float, default=1.0)
    p.add_argument("--max-job-chips", type=int, default=256)
    p.add_argument("--max-time", type=float)
    p.add_argument("--curves", help="goodput curve cache (optimus)")
    p.add_argument("--online", action="store_true",
                   help="profile unseen models live (optimus, with --curves), on --device")
    p.add_argument("--faults", metavar="SPEC",
                   help="inject hardware faults: k=v pairs, e.g. "
                        "mtbf=86400,repair=3600,ckpt=1800 (keys: mtbf, "
                        "repair, maintenance, maintenance_duration, spot, "
                        "spot_mtbf, spot_outage, spot_warning (pre-revoke "
                        "notice window: emergency checkpoints when it "
                        "covers the write cost), domain_mtbf / "
                        "domain_repair (correlated host/rack/pod "
                        "outages), domain_host / domain_rack / "
                        "domain_pod (per-level outage-rate multipliers), "
                        "hazard_shape (Weibull shape; 1 = memoryless), "
                        "hazard_util (wear-driven aging weight), "
                        "migrate_threshold (proactive checkpoint-and-"
                        "migrate trigger), straggler_mtbf / "
                        "straggler_repair / "
                        "straggler_degrade (slow chips pacing their "
                        "gangs), link_mtbf / link_repair / link_degrade, "
                        "ckpt, restore, ckpt_write (priced periodic "
                        "checkpoint writes; 'auto' sizes from model "
                        "state); seconds, inf ok, restore=auto derives "
                        "cost from the model size).  The fault schedule "
                        "derives from --seed via independent RNG "
                        "streams, so trace and faults reproduce together")
    p.add_argument("--net", nargs="?", const=True, default=None,
                   metavar="SPEC",
                   help="model the shared DCN fabric (net/): multislice "
                        "jobs get max-min fair bandwidth shares instead "
                        "of the static isolated-fabric speed factor, "
                        "re-priced on every running-set change.  SPEC is "
                        "k=v pairs: os (core oversubscription ratio, "
                        "default 4), ingest (Gbps per occupied chip, "
                        "default 0.05), uplinks (redundant sibling "
                        "uplinks per pod, default 1; >1 arms adaptive "
                        "routing around degraded links), partial "
                        "(bottleneck-group partial re-solve with the "
                        "hierarchical core tier, default 0).  TPU "
                        "clusters only; enables the "
                        "'contention' placement scheme's residual-"
                        "bandwidth scoring and ('link', pod) fault "
                        "degradation")
    p.add_argument("--accounting", choices=("v1", "v2"), default="v1",
                   help="progress-accounting version: v1 (default) keeps the "
                        "chunk-per-batch integration and its byte-identity "
                        "contract; v2 integrates lazily / vectorized under an "
                        "exact-sum closure contract instead.  v2 rides the "
                        "config hash")
    p.add_argument("--device", default=None,
                   help="where --online profiles: 'cpu' for the plain PyTorch versions; "
                        "default: the card")


def build_parser() -> argparse.ArgumentParser:
    from gpuschedule_tpu_torch.policies import available

    p = argparse.ArgumentParser(prog="gpuschedule_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="replay a trace under a policy")
    _add_world_args(run)
    run.add_argument("--out", help="directory for jobs/utilization CSVs")
    run.add_argument("--prefix", default="")
    run.add_argument("--events", nargs="?", const=True, default=None,
                     metavar="PATH",
                     help="record a structured events.jsonl stream (streamed "
                          "incrementally, constant memory).  With PATH the "
                          "stream goes there directly; the bare flag writes "
                          "events.jsonl under --out.  The stream opens with "
                          "a schema header (run_id/seed/policy/config_hash) "
                          "for `report` and `compare`")
    run.add_argument("--perfetto", metavar="PATH",
                     help="export the replay as a Chrome/Perfetto trace "
                          "(one track per pod/slice, one slice per job "
                          "occupancy interval); implies event recording")
    run.add_argument("--spans", action="store_true",
                     help="enable the span tracer (engine batches + policy invocations); "
                          "writes spans.trace.json under --out and prints a span summary "
                          "to stderr")
    run.add_argument("--attrib", action="store_true",
                     help="causal slowdown attribution: blame every queued interval with "
                          "its cause and split running time into legs; adds "
                          "delay_<cause>_s keys to the summary line")
    run.add_argument("--snapshot", metavar="PATH",
                     help="with --snapshot-every: serialize the full "
                          "engine state here periodically, making the "
                          "replay crash-resumable (run --resume PATH)")
    run.add_argument("--snapshot-every", type=float, metavar="SECONDS",
                     help="sim-seconds between engine snapshots (arms "
                          "together with --snapshot)")
    run.add_argument("--resume", metavar="SNAPSHOT",
                     help="restore a mid-replay engine from a --snapshot "
                          "file and finish it; under v1 accounting the "
                          "finished outputs are byte-identical to the "
                          "uninterrupted run.  World-building flags are "
                          "ignored: the snapshot is the world")
    run.add_argument("--sample-interval", type=float, metavar="SECONDS",
                     help="periodic cluster-side samples every SECONDS of sim time; "
                          "sampling never perturbs the replay")
    run.add_argument("--prom", metavar="PATH",
                     help="write run counters/gauges/histograms in the Prometheus text "
                          "exposition format (with --out, metrics.prom/metrics.json are "
                          "written there too)")
    run.add_argument("--self-profile", metavar="PATH",
                     help="profile the replay loop itself: bucket each "
                          "batch's wall time into phases and write PATH as "
                          "a ui.perfetto.dev-loadable document with the "
                          "machine-readable 'selfprof' summary block; "
                          "replay output is byte-identical with or without "
                          "the flag")
    run.add_argument("--cache-stats", action="store_true",
                     help="engine cache telemetry: each cache's hit/miss/invalidate counts "
                          "as cache_<name>_<outcome> summary keys and the "
                          "engine_cache_events{cache,outcome} registry family")
    run.add_argument("--sample-on-change", action="store_true",
                     help="also sample whenever a batch changes the health/degrade masks")
    run.add_argument("--history", metavar="STORE",
                     help="append this run's summary to the sqlite history "
                          "store at STORE (created if missing), keyed by "
                          "run_id/config_hash; `history trend` renders "
                          "trajectories across invocations")
    run.add_argument("--flush-events", type=float, default=None,
                     metavar="SECONDS",
                     help="flush the --events stream to disk at least every "
                          "SECONDS of sim time.  Default: 512-record "
                          "batching only")
    run.set_defaults(fn=cmd_run)

    wi = sub.add_parser(
        "whatif",
        help="interactive what-if queries against a mirrored replay: "
             "pause the world at --at, then answer admit / drain / "
             "policy-swap questions by speculative forks with "
             "attributed deltas",
    )
    _add_world_args(wi)
    wi.add_argument("--at", type=float, required=True, metavar="SECONDS",
                    help="sim time to mirror the world at: the engine "
                         "replays to the last batch at or before this "
                         "instant and pauses there")
    wi.add_argument("--resume", metavar="SNAPSHOT",
                    help="mirror from an engine snapshot (e.g. a flight-"
                         "recorder pin from `watch --flight-dir`) instead "
                         "of rebuilding the world: restore, replay "
                         "forward to --at, and serve queries there.  "
                         "World-building flags are ignored — the "
                         "snapshot is the world")
    wi.add_argument("--horizon", type=float, default=86_400.0,
                    metavar="SECONDS",
                    help="bounded speculative-replay horizon per query "
                         "(default: one day of sim time); deltas compare "
                         "variant vs baseline forks at at+horizon")
    wi.add_argument("--pool", type=int, default=0, metavar="N",
                    help="persistent worker processes serving queries "
                         "concurrently (each restores the mirror once, "
                         "then forks per query); 0 (default) evaluates "
                         "in-process")
    wi.add_argument("--admit", action="append", metavar="SPEC",
                    help="admit query: chips=8,duration=3600"
                         "[,model=M][,at=T][,pods=0:2:5] — one candidate "
                         "evaluation per pod in pods (omitted: the "
                         "policy places it); repeatable")
    wi.add_argument("--drain", action="append", metavar="SPEC",
                    help="drain query: pod=7[,at=T][,duration=S] "
                         "(duration defaults to permanent); repeatable")
    wi.add_argument("--swap-policy", action="append", metavar="NAME",
                    choices=available(),
                    help="policy-swap query: rerun the future under "
                         "NAME; repeatable")
    wi.add_argument("--out", metavar="PATH",
                    help="also write the full result document here")
    wi.add_argument("--history", metavar="STORE",
                    help="append one history row per query (kind "
                         "'whatif') to the sqlite store at STORE")
    wi.add_argument("--prom", metavar="PATH",
                    help="write the query-latency histogram "
                         "(whatif_query_latency_ms{kind}) in Prometheus "
                         "text format")
    wi.add_argument("--trace-out", metavar="PATH", dest="trace_out",
                    help="write ONE merged Perfetto/Chrome trace of the "
                         "whole fleet: parent enqueue/dispatch/reassemble "
                         "spans plus a named track per worker, every "
                         "worker span carrying the propagated trace id; "
                         "also federates worker counters into --prom.  "
                         "Off by default — disarmed runs are "
                         "byte-identical")
    wi.set_defaults(fn=cmd_whatif)

    gen = sub.add_parser("gen-trace", help="write a synthetic trace CSV")
    gen.add_argument("--num-jobs", type=int, required=True)
    gen.add_argument("--seed", type=int, default=0)
    gen.add_argument("--philly-like", action="store_true")
    gen.add_argument("--arrival-rate", type=float, default=None,
                     help="jobs/sec; defaults to 1/60 (poisson) or the "
                          "published Philly rate 1/67.3 (--philly-like)")
    gen.add_argument("--mean-duration", type=float, default=3600.0)
    gen.add_argument("--failure-rate", type=float, default=0.0)
    gen.add_argument("--util-min", type=float, default=1.0)
    gen.add_argument("--out", required=True)
    gen.set_defaults(fn=cmd_gen_trace)

    fl = sub.add_parser(
        "faults",
        help="fault-injection demo: seeded chaos replay across the policy "
             "suite with goodput decomposition",
    )
    fl.add_argument("--policies",
                    help="comma list of policy configs (default: the whole "
                         "eight-policy suite; see tools.fault_sweep)")
    fl.add_argument("--mtbf", type=float, default=6 * 3600.0,
                    help="per-chip mean time between failures, seconds "
                         "(inf = fault-free control arm)")
    fl.add_argument("--repair", type=float, default=3600.0,
                    help="mean repair duration, seconds")
    fl.add_argument("--ckpt", type=float, default=1800.0,
                    help="checkpoint interval in work-seconds (progress "
                         "rolls back to the last multiple on a fault)")
    fl.add_argument("--restore", default="auto",
                    help="restart cost per revocation: seconds, or 'auto' "
                         "to derive from model size and slice shape")
    fl.add_argument("--num-jobs", type=int, default=200,
                    help="Philly-like trace length")
    fl.add_argument("--seed", type=int, default=0,
                    help="governs trace AND fault streams (seed-split rule)")
    fl.add_argument("--dims", default="8x8", help="TPU pod dims")
    fl.add_argument("--pods", type=int, default=1)
    fl.add_argument("--max-time", type=float,
                    help="horizon cutoff (also bounds schedule generation)")
    fl.add_argument("--out", help="also write the JSON document here")
    fl.add_argument("--events", metavar="DIR",
                    help="capture one <policy>.events.jsonl per cell into "
                         "DIR (each with its own schema header), ready for "
                         "`report` / `compare`")
    fl.set_defaults(fn=cmd_faults)

    rep = sub.add_parser(
        "report",
        help="render an events.jsonl stream as one self-contained HTML "
             "report (inline CSS/SVG, zero network fetches)",
    )
    rep.add_argument("--events", required=True, metavar="EVENTS_JSONL",
                     help="stream captured by `run --events`")
    rep.add_argument("--out", required=True, metavar="REPORT_HTML")
    rep.add_argument("--title", help="report heading (default: from header)")
    rep.add_argument("--json", metavar="PATH",
                     help="also dump the full analysis document as JSON")
    rep.add_argument("--no-header", action="store_true",
                     help="admit bare streams captured without run identity "
                          "(Python API without run_meta)")
    rep.add_argument("--low-mem", action="store_true",
                     help="bounded-memory analysis: spill finished job "
                          "records to a sqlite temp store; the HTML is "
                          "byte-identical, the --json document's means may "
                          "differ in their last digits (summation order)")
    rep.add_argument("--selfprof", metavar="PROFILE_JSON",
                     help="fold a `run --self-profile` document into the "
                          "report's Engine-health panel")
    rep.add_argument("--alerts", metavar="ALERTS_JSONL",
                     help="fold an alerts side stream into the report: "
                          "timeline ticks on the occupancy chart plus a "
                          "per-detector Alerts panel")
    rep.set_defaults(fn=cmd_report)

    cmpr = sub.add_parser(
        "compare",
        help="regression-diff two event streams for CI gating (exit 0 "
             "within thresholds, 1 regressed, 2 not comparable); three "
             "or more render an n-way policy x metric matrix",
    )
    cmpr.add_argument("streams", nargs="+", metavar="EVENTS_JSONL",
                      help="two streams: baseline + candidate (the CI "
                           "gate); three or more: n-way matrix columns")
    cmpr.add_argument("--threshold", action="append",
                      metavar="FLOAT|METRIC=FLOAT",
                      help="relative worsening gate: a bare float sets the "
                           "default (0.05), METRIC=FLOAT overrides one "
                           "metric; repeatable.  Negative values demand "
                           "improvement")
    cmpr.add_argument("--allow-mismatch", action="store_true",
                      help="compare runs of different seeds/configs anyway")
    cmpr.add_argument("--json", metavar="PATH",
                      help="write the machine-readable diff here")
    cmpr.add_argument("--low-mem", action="store_true",
                      help="bounded-memory analysis of each stream (see "
                           "report --low-mem: means may differ in their "
                           "last digits)")
    cmpr.add_argument("--history", metavar="STORE",
                      help="append every compared stream's summary to the "
                           "sqlite history store (keyed by its header "
                           "identity)")
    cmpr.set_defaults(fn=cmd_compare)

    hist = sub.add_parser(
        "history",
        help="cross-run history store: list appended results and render "
             "per-metric trajectories across invocations",
    )
    hist.add_argument("action", choices=("list", "trend"),
                      help="list: matching rows; trend: per-metric "
                           "trajectory table with step deltas")
    hist.add_argument("--store", required=True, metavar="STORE",
                      help="sqlite store written by run/compare --history")
    hist.add_argument("--metric", action="append", metavar="NAME",
                      help="summary metric(s) to render (trend; "
                           "repeatable; default avg_jct)")
    hist.add_argument("--kind", help="filter: run / compare / bench")
    hist.add_argument("--config", metavar="HASH",
                      help="filter by config_hash")
    hist.add_argument("--label", help="filter by bench label, e.g. "
                                      "plain/1000")
    hist.add_argument("--last", type=int, metavar="N",
                      help="only the newest N matching rows")
    hist.add_argument("--json", metavar="PATH",
                      help="also write the matching rows as JSON")
    hist.set_defaults(fn=cmd_history)

    cmp_ = sub.add_parser("compare-topology",
                          help="config #5: GPU placement schemes vs TPU slices")
    cmp_.add_argument("--policy", choices=available(), default="fifo")
    cmp_.add_argument("--policy-arg", action="append", metavar="K=V",
                      help="policy constructor kwarg (JSON values), e.g. "
                           "backfill=true")
    cmp_.add_argument("--philly")
    cmp_.add_argument("--synthetic", type=int)
    cmp_.add_argument("--seed", type=int, default=0)
    cmp_.add_argument("--gpu-shape", default="4x8x8")
    cmp_.add_argument("--seeds", type=int, default=1,
                      help="random-placement draws to average (config #5 "
                           "seed sweep)")
    cmp_.add_argument("--load-sweep", action="store_true",
                      help="also sweep offered load (70/80/90/95%%) and "
                           "report the acceptance band per load")
    cmp_.add_argument("--out")
    cmp_.set_defaults(fn=cmd_compare_topology)

    tr = sub.add_parser("train", help="train a model on a device mesh")
    tr.add_argument("--model", required=True)
    tr.add_argument("--steps", type=int, default=10)
    tr.add_argument("--batch-size", type=int, default=8)
    tr.add_argument("--seq-len", type=int, default=128)
    tr.add_argument("--lr", type=float, default=1e-3)
    tr.add_argument("--warmup-steps", type=int, default=0,
                    help="linear LR warmup steps (0 = none)")
    tr.add_argument("--decay-steps", type=int, default=None,
                    help="cosine-decay LR to zero over this many post-warmup steps")
    tr.add_argument("--grad-clip", type=float, default=None,
                    help="global-norm gradient clipping threshold")
    tr.add_argument("--sp", type=int, default=1)
    tr.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (megatron splits, the MoE's experts over tp)")
    tr.add_argument("--pp", type=int, default=1,
                    help="pipeline stages (>=2 trains the staged PipelinedLM; incompatible "
                         "with --sp/--tp/--ring-attn)")
    tr.add_argument("--microbatches", type=int, default=4,
                    help="pipeline microbatch count M (bubble fraction (pp-1)/(M+pp-1); "
                         "only with --pp >= 2)")
    tr.add_argument("--pp-schedule", choices=("gpipe", "remat"), default="gpipe",
                    help="pipeline activation-memory schedule: gpipe keeps each "
                         "microbatch's stage internals, remat recomputes them from the "
                         "stage's input")
    tr.add_argument("--devices", type=int,
                    help="the mesh's devices, one a rank: must be the launcher's world "
                         "size (default: the world)")
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--flash-attn", action="store_true",
                    help="the CUDA flash-attention kernels as the attention core")
    tr.add_argument("--ring-attn", action="store_true",
                    help="sequence-shard over sp with ring attention (with --flash-attn, "
                         "the ring-flash composition)")
    tr.add_argument("--data", help="flat binary token file (see data/)")
    tr.add_argument("--data-dtype", default="uint16")
    tr.add_argument("--host-shard", default=None, metavar="INDEX,COUNT",
                    help="multi-host input split: this host yields every "
                         "COUNT-th batch starting at INDEX (streams "
                         "partition the epoch exactly; resume offsets "
                         "stay host-count-independent)")
    tr.add_argument("--ckpt", help="save final state here (torch.distributed.checkpoint)")
    tr.add_argument("--restore", help="resume from this checkpoint")
    tr.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions; default: the card")
    tr.set_defaults(fn=cmd_train)

    obs = sub.add_parser("obs", help="observability utilities (trace export)")
    obs_sub = obs.add_subparsers(dest="obs_cmd", required=True)
    exp = obs_sub.add_parser(
        "export",
        help="convert a run's events.jsonl into a ui.perfetto.dev-loadable "
             "Chrome trace-event JSON",
    )
    exp.add_argument("--events", required=True, metavar="EVENTS_JSONL",
                     help="events.jsonl written by `run --events --out`")
    exp.add_argument("--out", required=True, metavar="TRACE_JSON")
    exp.set_defaults(fn=cmd_obs_export)

    prof = sub.add_parser("profile", help="fit goodput curves from a step measured on the device")
    prof.add_argument("--model", action="append", required=True)
    prof.add_argument("--ks", default="1,2,4,8,16,32,64")
    prof.add_argument("--generation", default="v5e",
                      help="TPU generation whose ICI/DCN model extends the measured step")
    prof.add_argument("--batch-size", type=int, default=8)
    prof.add_argument("--seq-len", type=int, default=128)
    prof.add_argument("--sp", type=int, default=1,
                      help="sequence-parallel ranks of a measured replica (dense attention "
                           "over the sequence gathered over sp)")
    prof.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks of a measured replica")
    prof.add_argument("--pp", type=int, default=1,
                      help="pipeline stages of a measured replica (the staged PipelinedLM; "
                           "composes with dp only)")
    prof.add_argument("--curves", required=True)
    prof.add_argument("--trace-dir", help="also write a torch.profiler Chrome trace of the step here")
    prof.add_argument("--device", default=None,
                      help="'cpu' for the plain PyTorch versions; default: the card")
    prof.set_defaults(fn=cmd_profile)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
