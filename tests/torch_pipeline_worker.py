"""Rank body of ``tests/test_torch_pipeline_dist.py``: one gloo rank of a
world of four on the CPU.  Imports no JAX; the JAX pipeline's parameters
arrive as numpy arrays in an ``.npz`` (flax paths joined by ``/``)."""

import contextlib
import io
import json
import os
import sys
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

# (model, dp, microbatches, flash_attn, schedule) of each case, on a pp 2 mesh
CASES = {
    "dense": ("transformer-tiny", 2, 4, False, "gpipe"),
    "dense_dp1": ("transformer-tiny", 1, 2, False, "gpipe"),
    "flash": ("transformer-tiny", 2, 2, True, "remat"),
    "moe": ("moe-top2-tiny", 2, 2, False, "gpipe"),
}
BATCH, SEQ = 8, 32


def tree(data, prefix):
    """The nested dict of the arrays named ``prefix/...`` in ``data``."""
    out = {}
    for key in data.files:
        if key.startswith(prefix + "/"):
            node = out
            *path, leaf = key[len(prefix) + 1:].split("/")
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    return out


def grads_of(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def run(rank, world, store, data_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        found, arrays = _checks(rank, np.load(data_path), Path(out_dir))
    finally:
        dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **arrays)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(found))


def _trainer(case, mesh, **kw):
    from gpuschedule_tpu_torch.parallel import PipelinedLM

    model, dp, m, flash, schedule = CASES[case]
    kw.setdefault("schedule", schedule)
    return PipelinedLM(model, mesh, batch_size=BATCH, seq_len=SEQ, num_microbatches=m,
                       flash_attn=flash, **kw)


def _loaded(trainer, data, case):
    from gpuschedule_tpu_torch.convert import params_from_jax

    state = trainer.init(seed=0)
    state.model.load_state_dict(params_from_jax(tree(data, f"{case}:p0"), trainer.cfg,
                                                stage=trainer.stage))
    return state


def _checks(rank, data, out):
    from gpuschedule_tpu_torch import cli
    from gpuschedule_tpu_torch.parallel import ShardedTrainer, make_mesh
    from gpuschedule_tpu_torch.parallel.mesh import sub_mesh
    from gpuschedule_tpu_torch.profiler import CurveCache, profile_model

    found, arrays = {}, {}
    for case, (model, dp, m, flash, schedule) in CASES.items():
        mesh = sub_mesh(2 * dp, dp=dp, pp=2, device="cpu")
        if mesh is None:
            continue
        trainer = _trainer(case, mesh)
        batches = [trainer.to_device(b) for b in data[f"{case}:tokens"]]
        state = _loaded(trainer, data, case)
        state.optimizer.zero_grad()
        loss0 = trainer.loss_and_grads(state, batches[0])
        grads = grads_of(state.model)
        arrays.update({f"{case}:grad:{n}": g.numpy() for n, g in grads.items()})
        seq_loss, seq_err = _sequential(trainer, data, case, grads)
        losses = []
        for b in batches:
            state, loss = trainer.step(state, b)
            losses.append(loss.item())
        found[case] = {"coords": [mesh.coordinate("pp"), mesh.coordinate("dp")],
                       "grad_loss": loss0.item(), "losses": losses,
                       "sequential_loss": seq_loss, "sequential_grad_err": seq_err,
                       "local_batch": list(batches[0].shape)}
        if case == "dense":
            # the other schedule from the same parameters: equal to the bit
            other = _trainer(case, mesh, schedule="remat")
            ostate = _loaded(other, data, case)
            ostate.optimizer.zero_grad()
            oloss = other.loss_and_grads(ostate, batches[0])
            found["remat_equal"] = bool(oloss.item() == loss0.item() and all(
                torch.equal(g, grads[n]) for n, g in grads_of(ostate.model).items()))
            ostate.optimizer.zero_grad()
            ostate, l1 = other.step(ostate, batches[0])
            found["remat_step_equal"] = bool(l1.item() == losses[0] and all(
                torch.equal(p, q) for p, q in zip(ostate.model.parameters(),
                                                  _after_one(trainer, data, case, batches))))
            found["ckpt"] = _ckpt(trainer, data, case, batches, out, losses)
    # the command line: train --pp on the four ranks, and its checkpoint
    ck = out / "cli_ckpt"
    argv = ["train", "--model", "transformer-tiny", "--steps", "3", "--batch-size", "8",
            "--seq-len", "32", "--pp", "2", "--microbatches", "4", "--pp-schedule", "remat",
            "--device", "cpu", "--ckpt", str(ck)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    found["cli"] = {"rc": rc, "out": buf.getvalue()}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv[:-2] + ["--restore", str(ck), "--steps", "2"])
    found["cli_restore"] = {"rc": rc, "out": buf.getvalue()}
    # profile over a pp 2 mesh of the first 2 ranks
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        profile_model("transformer-tiny", pp=2, ks=(2, 64), batch_size=8, seq_len=32,
                      cache=CurveCache(str(out / "curves.json")), device="cpu")
    found["profile_warnings"] = [str(w.message) for w in seen]
    for kw in (dict(pp=2, sp=2), dict(pp=2, ks=(3,))):
        try:
            profile_model("transformer-tiny", device="cpu", **kw)
        except ValueError as e:
            found.setdefault("profile_errors", []).append(str(e))
    try:
        ShardedTrainer("transformer-tiny", make_mesh(pp=2, device="cpu"), batch_size=8,
                       seq_len=32)
    except ValueError as e:
        found["sharded_pp_error"] = str(e)
    return found, arrays


def _sequential(trainer, data, case, grads):
    """(the loss, and the worst gradient error over each tensor's largest
    entry) of the whole model holding every stage's parameters, its blocks
    run in sequence on each (microbatch, dp column) share of the global
    batch (``reference_loss(per_microbatch=True)``), against this rank's
    pipelined ``grads``.  The key bias, whose exact gradient is 0, is held
    to the largest entry of the model's gradients."""
    from gpuschedule_tpu_torch.convert import params_from_jax
    from gpuschedule_tpu_torch.models import build_model
    from gpuschedule_tpu_torch.parallel.pipeline import whole_names

    params = tree(data, f"{case}:p0")
    model, cfg = build_model(trainer.model_name, attn_fn=trainer.attn_fn)
    whole = {}
    for stage in range(trainer.pp):
        whole.update(whole_names(params_from_jax(params, cfg, stage=stage),
                                 stage * trainer.layers_per_stage))
    model.load_state_dict(whole)
    tokens = torch.from_numpy(np.asarray(data[f"{case}:tokens"][0])).long()
    loss = trainer.reference_loss(model, tokens, per_microbatch=True)
    loss.backward()
    ref = whole_names(dict(model.named_parameters()), 0)
    mine = whole_names(grads, trainer.first_layer)
    top = max(p.grad.abs().max().item() for p in ref.values())
    worst = 0.0
    for name, g in mine.items():
        r = ref[name].grad
        scale = top if name.endswith("attn.key.bias") else r.abs().max().item()
        worst = max(worst, (g - r).abs().max().item() / scale)
    return loss.item(), worst


def _after_one(trainer, data, case, batches):
    """The parameters after one gpipe step from the JAX parameters."""
    state = _loaded(trainer, data, case)
    state, _ = trainer.step(state, batches[0])
    return list(state.model.parameters())


def _ckpt(trainer, data, case, batches, out, straight):
    """Save after one step, restore onto a new trainer and onto a dp 4
    one-rank-layout trainer: the resumed losses against the straight run's."""
    from gpuschedule_tpu_torch.parallel import ShardedTrainer, make_mesh
    from gpuschedule_tpu_torch.parallel.checkpoint import restore_state, save_state

    state = _loaded(trainer, data, case)
    state, _ = trainer.step(state, batches[0])
    path = save_state(state, out / "pp_ckpt")
    resumed = restore_state(_trainer(case, trainer.mesh), path)
    count = resumed.optimizer.count()
    losses = []
    for b in batches[1:]:
        resumed, loss = trainer.step(resumed, b)
        losses.append(loss.item())
    flat = ShardedTrainer("transformer-tiny", make_mesh(device="cpu"), batch_size=BATCH,
                          seq_len=SEQ)
    fstate = restore_state(flat, path)
    tokens = np.asarray(data[f"{case}:tokens"][1])
    _, floss = flat.step(fstate, flat.to_device(tokens))
    return {"resumed": losses, "straight": straight[1:], "count": count,
            "files": sorted(os.listdir(path)), "dp4_loss": floss.item()}


if __name__ == "__main__":
    sys.exit("run through tests/test_torch_pipeline_dist.py")
