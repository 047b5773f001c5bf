"""Rank body of ``tests/test_torch_mesh_grads_dist.py``: one gloo rank of a
world of four on the CPU.  Imports no JAX; the JAX trainer's parameters
arrive as numpy arrays in an ``.npz`` (flax paths joined by ``/``)."""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from torch_pipeline_worker import tree

BATCH, SEQ = 4, 32
MOE = "moe-tiny"
MUTATED = "ln_f.scale"  # a replicated parameter; its gradient is scaled by tp on tp rank 1


def run(rank, world, store, data_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        found, arrays = _checks(np.load(data_path))
    finally:
        dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **arrays)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(found))


def _one_rank(model):
    """The trainer of the one-rank model, inside this world of ranks."""
    from gpuschedule_tpu_torch.parallel import Mesh, ShardedTrainer

    one = Mesh({"pp": 1, "dp": 1, "sp": 1, "tp": 1}, torch.device("cpu"))
    return ShardedTrainer(model, one, batch_size=BATCH, seq_len=SEQ)


def _grads(trainer, state, batch):
    state.optimizer.zero_grad()
    loss = trainer.loss_and_grads(state, batch)
    return loss.item(), {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}


def grad_errors(trainer, grads, ref, l2=False):
    """Each parameter's gradient error on this rank against the one-rank
    model's ``ref``: max abs error over the largest entry of the reference
    (a split parameter's slice, a replicated one whole), or with ``l2``
    the relative L2 error; the key bias, whose exact gradient is 0,
    against the largest of the model's."""
    from gpuschedule_tpu_torch.parallel.tp import param_partition_spec

    size = (lambda t: t.norm().item()) if l2 else (lambda t: t.abs().max().item())
    top = max(size(g) for g in ref.values())
    out = {}
    for name, g in grads.items():
        dim = None if name == "input" else param_partition_spec(name, g.dim())
        r = trainer.tp.shard(ref[name], dim)
        scale = top if name.endswith("attn.key.bias") else size(r)
        out[name] = size(g - r) / scale
    return out


def _checks(data):
    from gpuschedule_tpu_torch.convert import params_from_jax
    from gpuschedule_tpu_torch.parallel import ShardedTrainer, make_mesh
    from gpuschedule_tpu_torch.parallel import train as train_mod

    found, arrays = {}, {}
    # the gathered sequence: dp 2 x sp 2, dense attention over the gathered k, v
    mesh = make_mesh(sp=2, device="cpu")
    trainer = ShardedTrainer("transformer-tiny", mesh, batch_size=BATCH, seq_len=SEQ,
                             seq_shard=True, learning_rate=3e-3)
    state = trainer.init(seed=0)
    state.model.load_state_dict(params_from_jax(tree(data, "sp:p0"), trainer.cfg))
    batches = [trainer.to_device(b) for b in data["sp:tokens"]]
    loss0, grads = _grads(trainer, state, batches[0])
    arrays.update({f"sp:grad:{n}": g.numpy() for n, g in grads.items()})
    one = _one_rank("transformer-tiny")
    ostate = one.init(seed=0)
    ostate.model.load_state_dict(state.model.state_dict())
    _, ref = _grads(one, ostate, one.to_device(data["sp:tokens"][0]))
    losses = []
    for b in batches:
        state, loss = trainer.step(state, b)
        losses.append(loss.item())
    found["sp"] = {"coords": [mesh.coordinate("dp"), mesh.coordinate("sp")],
                   "attn": trainer.attn_fn.func.__name__, "grad_loss": loss0,
                   "losses": losses, "one_rank_err": max(grad_errors(one, grads, ref).values()),
                   "local_batch": list(batches[0].shape)}
    # tp's gradients against the one-rank model's, then with a replicated
    # parameter's gradient scaled by tp on one rank (the fault the check is for)
    mesh = make_mesh(tp=2, device="cpu")
    original = train_mod._all_reduce_grads

    def scaled(params, group):
        params = list(params)
        original(params, group)
        if mesh.coordinate("tp") == 1:
            dict(state.model.named_parameters())[MUTATED].grad.mul_(mesh.shape["tp"])

    one = _one_rank("transformer-tiny")
    ostate = one.init(seed=0)
    tokens = np.asarray(data["tp:tokens"])
    _, ref = _grads(one, ostate, one.to_device(tokens))
    trainer = ShardedTrainer("transformer-tiny", mesh, batch_size=BATCH, seq_len=SEQ)
    state = trainer.init(seed=0)  # each rank's slice of the one-rank draws
    batch = trainer.to_device(tokens)
    _, grads = _grads(trainer, state, batch)
    clean = grad_errors(trainer, grads, ref, l2=True)
    train_mod._all_reduce_grads = scaled
    try:
        _, grads = _grads(trainer, state, batch)
    finally:
        train_mod._all_reduce_grads = original
    found["tp"] = {"tp": mesh.coordinate("tp"), "clean": clean,
                   "mutated": grad_errors(trainer, grads, ref, l2=True)}
    found["moe"] = _moe_module(mesh, tokens)
    return found, arrays


def _moe_module(mesh, tokens):
    """Block 0's MoE module over dp 2 x tp 2 (its experts split over tp,
    routing the global batch) against the one-rank model's on that model's
    input to it and one cotangent: the gradients of ``sum(y·g) + aux``
    with respect to each parameter (summed over the data group, held
    slice by slice) and to the rank's rows of the input.  A whole model's
    gradients are no check of the MoE over tp: a route flips on a bf16 ulp
    of a block's input, which tp's row-parallel sums round other than one
    product does, and a flipped token moves every gradient below it."""
    from gpuschedule_tpu_torch.parallel import ShardedTrainer

    one = _one_rank(MOE)
    whole = one.init(seed=0).model
    grab = {}
    hook = whole.blocks[0].moe.register_forward_pre_hook(
        lambda mod, args: grab.setdefault("x", args[0]))
    with torch.no_grad():
        whole(one.to_device(tokens))
    hook.remove()
    trainer = ShardedTrainer(MOE, mesh, batch_size=BATCH, seq_len=SEQ)
    moe = trainer.init(seed=0).model.blocks[0].moe
    x = grab["x"]
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(7)).to(x.dtype)
    rows = slice(trainer.row0, trainer.row0 + trainer.rows)
    grads = []
    for module, xs, gs in ((whole.blocks[0].moe, x, g), (moe, x[rows], g[rows])):
        xs = xs.detach().clone().requires_grad_(True)
        y, aux = module(xs)
        ((y.float() * gs.float()).sum() + aux).backward()
        grads.append({"input": xs.grad, **{f"blocks.0.moe.{n}": p.grad
                                           for n, p in module.named_parameters()}})
    ref, mine = grads
    for name, t in mine.items():
        if name != "input":
            dist.all_reduce(t, group=mesh.data_group)
    ref["input"] = ref["input"][rows]
    return grad_errors(trainer, mine, ref, l2=True)


if __name__ == "__main__":
    sys.exit("run through tests/test_torch_mesh_grads_dist.py")
