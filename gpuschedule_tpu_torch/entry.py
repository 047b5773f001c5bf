"""Driver entry points on the port's side: the flagship's forward and the
multi-rank dryrun.

Counterparts of the root ``__graft_entry__.py``'s ``entry`` and
``dryrun_multichip``, which stay as they are.

- :func:`entry` returns the flagship model's forward and example
  arguments: ``transformer-large``, its parameters drawn from seed 0, a
  (4, 128) token batch, on the card.
- :func:`dryrun_multichip` runs the reference's three steps as n ranks
  (gloo, one process a rank, spawned here), each step's loss checked
  finite: a dp x sp x tp ring-flash step of ``transformer-tiny``, a
  ``moe-top2-tiny`` step with ep-over-tp, and a ``PipelinedLM`` step at
  pp 2; then it prints the reference's summary line.  Its ranks run on the
  card (time-sliced on one: gloo stages CUDA tensors through host memory)
  unless ``device="cpu"``.

    python -m gpuschedule_tpu_torch.entry [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
from pathlib import Path

import torch

FLAGSHIP = "transformer-large"


def entry(device=None):
    """(fn, example_args): the flagship's forward, ``fn(*example_args)``
    giving its f32 logits, on the card unless ``device="cpu"``."""
    from gpuschedule_tpu_torch import resolve_device
    from gpuschedule_tpu_torch.models import build_model

    dev = resolve_device(device)
    with dev:
        model, _ = build_model(FLAGSHIP)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.zeros((4, 128), dtype=torch.int64, device=dev)

    def forward(model, tokens):
        with torch.no_grad():
            return model(tokens)

    return forward, (model, tokens)


def _factor(n: int):
    """(dp, sp, tp) of the reference's dryrun: tp and sp take a 2 each
    when n allows, dp the rest."""
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % 4 == 0 else 1
    return n // (sp * tp), sp, tp


def _finite(loss: torch.Tensor, what: str) -> float:
    value = loss.item()
    if not math.isfinite(value):
        raise RuntimeError(f"dryrun produced a non-finite loss {value} in {what}")
    return value


def _dryrun_rank(rank: int, n: int, store: str, out_dir: str, device: str) -> None:
    """One rank of :func:`dryrun_multichip`; rank 0 writes the losses."""
    import torch.distributed as dist

    from gpuschedule_tpu_torch.parallel import PipelinedLM, ShardedTrainer, make_mesh

    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n)
    try:
        dp, sp, tp = _factor(n)
        mesh = make_mesh(dp=dp, sp=sp, tp=tp, device=device)
        # long context over sp: the ring, with the flash kernels per chunk
        trainer = ShardedTrainer("transformer-tiny", mesh, batch_size=2 * dp, seq_len=64,
                                 seq_shard=sp > 1, ring_attn=sp > 1, flash_attn=sp > 1)
        _, loss = trainer.step(trainer.init(seed=0), trainer.make_batch(seed=0))
        found = {"mesh": [dp, sp, tp], "loss": _finite(loss, f"the mesh (dp={dp}, sp={sp}, "
                                                             f"tp={tp})")}
        if tp > 1:  # expert parallelism: the experts over tp, top-2 routing
            moe = ShardedTrainer("moe-top2-tiny", mesh, batch_size=2 * dp, seq_len=32)
            _, loss = moe.step(moe.init(seed=0), moe.make_batch(seed=0))
            found["moe"] = _finite(loss, "the MoE step")
        if n % 2 == 0:  # the pipeline at pp 2, dp the rest
            plm = PipelinedLM("transformer-tiny", make_mesh(pp=2, device=device),
                              batch_size=n, seq_len=32, num_microbatches=2)
            _, loss = plm.step(plm.init(seed=0), plm.make_batch(seed=0))
            found["pipeline"] = _finite(loss, "the pipeline step")
    finally:
        dist.destroy_process_group()
    if rank == 0:
        Path(out_dir, "dryrun.json").write_text(json.dumps(found))


def dryrun_multichip(n_devices: int, device=None) -> str:
    """One train step of each of the reference's three layouts over
    ``n_devices`` gloo ranks (spawned processes); returns and prints the
    summary line.  A rank that fails raises here."""
    import torch.multiprocessing as mp

    from gpuschedule_tpu_torch import resolve_device

    dev = resolve_device(device).type
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_dryrun_rank, nprocs=n_devices, start_method="spawn",
                           args=(n_devices, os.path.join(tmp, "store"), tmp, dev))
        found = json.loads(Path(tmp, "dryrun.json").read_text())
    dp, sp, tp = found["mesh"]
    moe = f"{found['moe']:.4f}" if "moe" in found else "skipped (tp=1)"
    pipe = f"{found['pipeline']:.4f}" if "pipeline" in found else "skipped (odd n)"
    line = (f"dryrun_multichip ok: mesh(dp={dp}, sp={sp}, tp={tp}) loss={found['loss']:.4f} "
            f"moe_ep_loss={moe} pipeline_pp2={pipe}")
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpuschedule_tpu_torch.entry")
    p.add_argument("n", type=int, nargs="?", default=8)
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain PyTorch versions; default: the card")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
