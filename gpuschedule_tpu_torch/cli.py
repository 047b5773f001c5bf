"""Command line: ``python -m gpuschedule_tpu_torch {train,profile} ...``.

Counterparts of the JAX package's subcommands:

- ``train`` builds a dp x sp mesh and the trainer over it, feeds it
  :func:`synthetic_lm_batches` and prints one JSON summary line with the
  JAX CLI's keys (``model``, ``steps``, ``mesh``, ``first_loss``,
  ``last_loss``, ``tokens_per_s`` rounded to 0.1, ``checkpoint``,
  ``resumed_at_step``), plus ``device``.  ``--sp``, ``--devices`` and
  ``--ring-attn`` mean what they mean there; the ranks come from the
  launcher (``torchrun --nproc-per-node N -m gpuschedule_tpu_torch train``),
  one a device, and rank 0 prints the line.  Without a launcher it runs on
  one device.  ``--tp`` above 1, ``--data``, ``--ckpt`` and ``--restore``
  are not ported yet (ROADMAP.md), so the last two keys are null.
  It trains the dense and MoE LMs; a CNN exits with the JAX CLI's
  message (image models are profile-only there too).
- ``profile`` measures each ``--model``'s step (any zoo model), fits its goodput curve into
  the ``--curves`` JSON that the simulator's Optimus policy reads
  (``gpuschedule_tpu run --policy optimus --curves``), and prints
  ``{"model", "theta"}`` per model, then ``{"model", "trace"}`` when
  ``--trace-dir`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
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
    if args.tp > 1:
        raise SystemExit(f"--tp {args.tp}: tensor parallelism is not ported yet (ROADMAP.md, "
                         "Queue 1 item 2)")
    try:
        joined = join_launcher_group(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    try:
        return _train(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args) -> int:
    from gpuschedule_tpu_torch.data import synthetic_lm_batches
    from gpuschedule_tpu_torch.parallel import ShardedTrainer, make_mesh

    try:
        mesh = make_mesh(sp=args.sp, tp=args.tp, devices=args.devices, device=args.device)
        trainer = ShardedTrainer(
            args.model,
            mesh,
            batch_size=args.batch_size,
            seq_len=args.seq_len,
            learning_rate=args.lr,
            seq_shard=args.ring_attn,
            ring_attn=args.ring_attn,
            flash_attn=args.flash_attn,
            warmup_steps=args.warmup_steps,
            decay_steps=args.decay_steps,
            grad_clip=args.grad_clip,
        )
    except (ValueError, NotImplementedError, RuntimeError) as e:
        raise SystemExit(str(e))
    if trainer.is_image:
        raise SystemExit(
            f"{args.model!r} is a CNN config; `train` feeds LM token "
            "batches (image models are profile-only for now)"
        )
    state = trainer.init(seed=args.seed)
    batches = synthetic_lm_batches(
        batch_size=trainer.batch_size, seq_len=args.seq_len,
        vocab=trainer.cfg.vocab, num_batches=args.steps, seed=args.seed,
    )
    first_loss = None
    t0 = None
    n = 0
    loss = None
    for tokens in batches:
        state, loss = trainer.step(state, trainer.to_device(tokens))
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
    dev = trainer.device
    if dist.is_initialized() and dist.get_rank() != 0:
        return 0  # the loss is the global mean on every rank: rank 0 reports it
    print(json.dumps({
        "model": args.model,
        "steps": n,
        "mesh": dict(mesh.shape),
        "first_loss": first_loss,
        "last_loss": last_loss,
        "tokens_per_s": tokens_per_s,
        "checkpoint": None,
        "resumed_at_step": None,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }, sort_keys=True))
    return 0


def cmd_profile(args) -> int:
    from gpuschedule_tpu_torch import resolve_device
    from gpuschedule_tpu_torch.profiler import CurveCache, capture_trace, profile_model

    try:
        device = resolve_device(args.device)
        ks = tuple(int(k) for k in args.ks.split(","))
    except (ValueError, RuntimeError) as e:
        raise SystemExit(str(e))
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
        print(json.dumps({"model": model, "theta": list(curve.theta)}))
        if args.trace_dir:
            path = capture_trace(model, f"{args.trace_dir}/{model}", batch_size=args.batch_size,
                                 seq_len=args.seq_len, device=device)
            print(json.dumps({"model": model, "trace": path}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gpuschedule_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
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
    tr.add_argument("--tp", type=int, default=1, help="not ported: must be 1")
    tr.add_argument("--devices", type=int,
                    help="the mesh's devices, one a rank: must be the launcher's world "
                         "size (default: the world)")
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--flash-attn", action="store_true",
                    help="the CUDA flash-attention kernels as the attention core")
    tr.add_argument("--ring-attn", action="store_true",
                    help="sequence-shard over sp with ring attention (with --flash-attn, "
                         "the ring-flash composition)")
    tr.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions; default: the card")
    tr.set_defaults(fn=cmd_train)

    prof = sub.add_parser("profile", help="fit goodput curves from a step measured on the device")
    prof.add_argument("--model", action="append", required=True)
    prof.add_argument("--ks", default="1,2,4,8,16,32,64")
    prof.add_argument("--generation", default="v5e",
                      help="TPU generation whose ICI/DCN model extends the measured step")
    prof.add_argument("--batch-size", type=int, default=8)
    prof.add_argument("--seq-len", type=int, default=128)
    prof.add_argument("--sp", type=int, default=1, help="not ported: must be 1")
    prof.add_argument("--tp", type=int, default=1, help="not ported: must be 1")
    prof.add_argument("--pp", type=int, default=1, help="not ported: must be 1")
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
