"""One rank of the 4-process gloo run of ``tests/test_torch_ring_dist.py``.

Imports nothing of JAX (each of the four processes would pay for it).  The
ranks meet through a ``FileStore`` under the test's ``tmp_path``, so
parallel test workers cannot collide on a port.  Each rank writes what it
found to ``rank<r>.json`` and its trainers' parameters after the steps to
``rank<r>.npz`` in the output directory (the CNN's under ``cnn:``); the
cross-mesh checkpoint goes to ``xmesh_ckpt`` there.
"""

from __future__ import annotations

import contextlib
import io
import json
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from gpuschedule_tpu_torch.cli import main as cli_main
from gpuschedule_tpu_torch.models import build_model
from gpuschedule_tpu_torch.ops import flash_attention
from gpuschedule_tpu_torch.parallel import (
    ShardedTrainer,
    make_mesh,
    ring_attention,
    ring_flash_attention,
)
from gpuschedule_tpu_torch.data import prefetch_to_device
from gpuschedule_tpu_torch.parallel.checkpoint import (
    reshard_state,
    restore_state,
    save_state,
    state_dict,
)
from gpuschedule_tpu_torch.parallel.ringattn import ring_attention_in_process
from gpuschedule_tpu_torch.parallel.ringflash import ring_flash_attention_in_process

WORLD = 4


def run(rank: int, store: str, data: str, out_dir: str) -> None:
    """The spawn target: join the group, check, write ``rank<r>.json``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD)
    try:
        found, params = _checks(np.load(data), out_dir)
    finally:
        dist.destroy_process_group()
    np.savez(Path(out_dir, f"rank{rank}.npz"), **params)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(found))


def _checks(data, out_dir) -> tuple:
    """What this rank found, and its trainer's parameters after the steps."""
    mesh = make_mesh(dp=2, sp=2, device="cpu")
    found = {"coords": [mesh.coordinate(a) for a in ("dp", "sp")], "rings": {}}

    # 1. the process-group ring against the in-process ring on the same inputs:
    # this rank's rows and chunk against the same slice of the whole
    q, k, v, g = (torch.from_numpy(data[n]) for n in "qkvg")
    rows = q.shape[0] // 2
    r0 = mesh.coordinate("dp") * rows
    chunk = q.shape[1] // 2
    c0 = mesh.coordinate("sp") * chunk
    for name, ring, in_process in (("flash", ring_flash_attention, ring_flash_attention_in_process),
                                   ("dense", ring_attention, ring_attention_in_process)):
        for causal in (True, False):
            mine = [x[r0:r0 + rows, c0:c0 + chunk].clone().requires_grad_(True)
                    for x in (q, k, v)]
            out = ring(*mine, mesh=mesh, causal=causal)
            grads = torch.autograd.grad(out, mine, g[r0:r0 + rows, c0:c0 + chunk])
            whole = [x[r0:r0 + rows].clone().requires_grad_(True) for x in (q, k, v)]
            ref = in_process(*whole, sp=2, causal=causal)
            ref_grads = torch.autograd.grad(ref, whole, g[r0:r0 + rows])
            pairs = [(out, ref)] + list(zip(grads, ref_grads))
            found["rings"][f"{name}-{'causal' if causal else 'full'}"] = max(
                (a - b[:, c0:c0 + chunk]).abs().max().item() for a, b in pairs)

    # 2. three ring-flash train steps from the JAX trainer's parameters
    trainer = ShardedTrainer("transformer-tiny", mesh, batch_size=4, seq_len=64,
                             learning_rate=3e-3, seq_shard=True, ring_attn=True,
                             flash_attn=True)
    state = trainer.init(seed=0)
    state.model.load_state_dict({name[2:]: torch.from_numpy(data[name])
                                 for name in data.files if name.startswith("p:")})
    found["losses"] = []
    for tokens in data["tokens"]:
        state, loss = trainer.step(state, trainer.to_device(tokens))
        found["losses"].append(float(loss))
    found["local_tokens"] = list(trainer.to_device(data["tokens"][0]).shape)
    params = {name: p.detach().numpy() for name, p in state.model.named_parameters()}

    # 3. the train CLI on the same group: rank 0 prints the summary line
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        found["cli_rc"] = cli_main(["train", "--model", "transformer-tiny", "--steps", "2",
                                    "--batch-size", "4", "--seq-len", "32", "--sp", "2",
                                    "--ring-attn", "--flash-attn", "--device", "cpu"])
    found["cli_out"] = buf.getvalue()

    # 4. an MoE model over the four ranks, the sequence split over sp
    # (ring-flash): block 0's routes, given the one-rank model's input to
    # it, are the one-rank module's for this rank's rows and chunk (the
    # counts of the row chunks ahead exchanged over dp x sp), then three
    # steps, the first loss beside the one-rank model's
    moe = ShardedTrainer("moe-top2-tiny", mesh, batch_size=4, seq_len=64, learning_rate=3e-3,
                         seq_shard=True, ring_attn=True, flash_attn=True)
    mstate = moe.init(seed=0)
    # the one-rank model: the trainer's init and loss, no ranks
    one, _ = build_model("moe-top2-tiny", attn_fn=partial(flash_attention, causal=True))
    one.reset_parameters(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(data["tokens"][0]).long()
    grab = {}
    hook = one.blocks[0].moe.register_forward_pre_hook(
        lambda mod, args: grab.setdefault("x", args[0]))
    with torch.no_grad():
        logits, aux = one.forward_with_aux(tokens)
        hook.remove()
        found["moe_one_rank_loss"] = float(ShardedTrainer.loss(logits, tokens)
                                           + moe.moe_aux_weight * sum(aux))
        d_ref, _, _ = one.blocks[0].moe.route(grab["x"])
        d, _, _ = mstate.model.blocks[0].moe.route(grab["x"][r0:r0 + rows, c0:c0 + chunk])
    mine = d_ref.view(4, 64, *d_ref.shape[1:])[r0:r0 + rows, c0:c0 + chunk].flatten(0, 1)
    found["moe_routes_equal"] = bool(torch.equal(d, mine)) and bool(d.any())
    found["moe_losses"] = []
    for tokens in data["tokens"]:
        mstate, loss = moe.step(mstate, moe.to_device(tokens))
        found["moe_losses"].append(float(loss))
    params.update({f"moe:{name}": p.detach().numpy()
                   for name, p in mstate.model.named_parameters()})

    # 5. the CNN over dp = 2 (the sp ranks hold replicas): three steps from
    # the JAX trainer's parameters on the same (images, labels) batches
    cnn = ShardedTrainer("resnet-tiny", mesh, batch_size=4, learning_rate=3e-3)
    cstate = cnn.init(seed=0)
    cstate.model.load_state_dict({name[4:]: torch.from_numpy(data[name])
                                  for name in data.files if name.startswith("cnn:")})
    found["cnn_losses"] = []
    for images, labels in zip(data["images"], data["labels"]):
        cstate, loss = cnn.step(cstate, cnn.to_device((images, labels)))
        found["cnn_losses"].append(float(loss))
    found["cnn_rows"] = [list(t.shape) for t in cnn.to_device((data["images"][0],
                                                                data["labels"][0]))]
    params.update({f"cnn:{name}": p.detach().numpy()
                   for name, p in cstate.model.named_parameters()})

    # 6. cross-mesh restore: one flash step at dp = 4 and a save, then a
    # restore at dp = 2 x sp = 2 with the ring (ring-flash); the next step
    # of each on the same batch, and the same move in memory
    found.update(_cross_mesh(data, out_dir))
    return found, params


def _cross_mesh(data, out_dir) -> dict:
    tokens = data["tokens"]
    kw = dict(batch_size=4, seq_len=64, learning_rate=3e-3, warmup_steps=1, decay_steps=4,
              grad_clip=0.5)
    src = ShardedTrainer("transformer-tiny", make_mesh(dp=4, device="cpu"), flash_attn=True, **kw)
    state, _ = src.step(src.init(seed=0), src.to_device(tokens[0]))
    path = save_state(state, Path(out_dir, "xmesh_ckpt"))
    dst = ShardedTrainer("transformer-tiny", make_mesh(dp=2, sp=2, device="cpu"),
                         seq_shard=True, ring_attn=True, flash_attn=True, **kw)
    restored = restore_state(dst, path)
    moved = reshard_state(dst, state)
    equal = all(torch.equal(a, b) for sd in (state_dict(restored), state_dict(moved))
                for a, b in zip(state_dict(state).values(), sd.values()))
    count = restored.optimizer.count()
    (fed,) = prefetch_to_device(iter([tokens[1]]), sharding=dst.batch_sharding)
    _, ref_loss = src.step(state, src.to_device(tokens[1]))
    _, loss = dst.step(restored, fed)
    return {"xmesh_loss": float(loss), "xmesh_ref_loss": float(ref_loss),
            "xmesh_values_equal": equal, "xmesh_count": count,
            "prefetch_equals_to_device": torch.equal(fed, dst.to_device(tokens[1]))}
