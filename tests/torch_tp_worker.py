"""One rank of the gloo runs of ``tests/test_torch_tp_dist.py``: four ranks
(a dp = 2 x tp = 2 mesh and the other layouts of four) or two.

Imports nothing of JAX (each process would pay for it).  The ranks meet
through a ``FileStore`` under the test's ``tmp_path``.  The JAX package's
data arrives in one ``.npz``: token batches, and flax trees flattened by
path (``<prefix>/block0/attn/query/kernel``), which each rank turns into
its shards with ``params_from_jax``.  Each rank writes what it found to
``w<world>rank<r>.json`` and its parameters to ``w<world>rank<r>.npz``.
"""

from __future__ import annotations

import contextlib
import io
import json
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from gpuschedule_tpu_torch.cli import main as cli_main
from gpuschedule_tpu_torch.convert import params_from_jax, unshard_state_dict
from gpuschedule_tpu_torch.models import MODEL_CONFIGS
from gpuschedule_tpu_torch.models.transformer import MoeMlp
from gpuschedule_tpu_torch.parallel import ShardedTrainer, make_mesh
from gpuschedule_tpu_torch.parallel.checkpoint import reshard_state, restore_state, save_state
from gpuschedule_tpu_torch.parallel.tp import NO_TP, TokenLayout, param_partition_spec
from gpuschedule_tpu_torch.profiler import CurveCache, profile_model

KW = dict(batch_size=4, learning_rate=3e-3)
# the JAX cross-mesh test's optimizer: warmup, decay and clip
XMESH_KW = dict(batch_size=4, seq_len=32, learning_rate=3e-3, warmup_steps=1, decay_steps=4,
                grad_clip=0.5)


def run(rank: int, world: int, store: str, data: str, out_dir: str) -> None:
    """The spawn target: join the group, check, write what was found."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        checks = _four if world == 4 else _two
        found, params = checks(np.load(data), Path(out_dir))
    finally:
        dist.destroy_process_group()
    np.savez(Path(out_dir, f"w{world}rank{rank}.npz"), **params)
    Path(out_dir, f"w{world}rank{rank}.json").write_text(json.dumps(found))


def _tree(data, prefix: str) -> dict:
    """The flax tree under ``prefix`` of the flattened ``data``."""
    tree: dict = {}
    for key in data.files:
        if key.startswith(prefix + "/"):
            node = tree
            *path, leaf = key[len(prefix) + 1:].split("/")
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    return tree


def _local(model) -> dict:
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _train(trainer, state, batches, before=None) -> list:
    """The losses of steps on ``batches``; with ``before`` (a step's whole
    parameters) the model takes its shards before each step: lockstep."""
    losses = []
    for i, tokens in enumerate(batches):
        if before is not None:
            whole = before(i)
            state.model.load_state_dict({
                n: trainer.tp.shard(t, param_partition_spec(n, t.dim())).contiguous()
                for n, t in whole.items()})
        state, loss = trainer.step(state, trainer.to_device(tokens))
        losses.append(float(loss))
    return losses


def _four(data, out: Path):
    mesh = make_mesh(dp=2, tp=2, device="cpu")
    found = {"coords": [mesh.coordinate("dp"), mesh.coordinate("tp")]}
    params = {}

    # 1. transformer-tiny on dp 2 x tp 2 (dense and flash) and ring-flash on
    # dp 1 x sp 2 x tp 2, three steps from the JAX trainer's parameters
    for key, kw, layout in (
            ("dense", {"seq_len": 32}, mesh),
            ("flash", {"seq_len": 32, "flash_attn": True}, mesh),
            ("ring", {"seq_len": 64, "flash_attn": True, "ring_attn": True, "seq_shard": True},
             make_mesh(dp=1, sp=2, tp=2, device="cpu"))):
        tr = ShardedTrainer("transformer-tiny", layout, **KW, **kw)
        state = tr.init(seed=0)
        state.model.load_state_dict(params_from_jax(_tree(data, f"{key}:p0"), tr.cfg, tr.tp))
        found[f"{key}_losses"] = _train(tr, state, data[f"{key}:tokens"])
        found[f"{key}_coords"] = [layout.coordinate(a) for a in ("dp", "sp", "tp")]
        params.update({f"{key}:{n}": v for n, v in _local(state.model).items()})

    # 2. a dp = 4 checkpoint restored onto dp 2 x tp 2, and the same move in
    # memory
    src = ShardedTrainer("transformer-tiny", make_mesh(dp=4, device="cpu"), flash_attn=True,
                         **XMESH_KW)
    tokens = data["dense:tokens"]
    state, _ = src.step(src.init(seed=0), src.to_device(tokens[0]))
    path = save_state(state, out / "xmesh_ckpt")
    dst = ShardedTrainer("transformer-tiny", mesh, flash_attn=True, **XMESH_KW)
    found.update(_restore_checks(src, state, dst, path, tokens[1]))

    # 3. the train CLI with --tp 2 on the group: rank 0 prints the summary
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        found["cli_rc"] = cli_main(["train", "--model", "moe-tiny", "--steps", "2",
                                    "--batch-size", "4", "--seq-len", "32", "--tp", "2",
                                    "--device", "cpu"])
    found["cli_out"] = buf.getvalue()

    # 4. the MoE on dp 2 x tp 2: MoeMlp's routes given flax's inputs (its
    # experts over tp, the counts over dp), then three trainer steps in
    # lockstep with the JAX trainer, whose parameters arrive in moe.npz
    rows = slice(2 * mesh.coordinate("dp"), 2 * mesh.coordinate("dp") + 2)
    trajectory = None
    for name in ("moe-tiny", "moe-top2-tiny"):
        cfg = MODEL_CONFIGS[name]
        tr = ShardedTrainer(name, mesh, seq_len=32, **KW)
        layer = MoeMlp(cfg, tr.tp)
        mod = _tree(data, f"{name}:mod")
        layer.load_state_dict({
            "router.kernel": torch.from_numpy(mod["router"]["kernel"]),
            "router.bias": torch.from_numpy(mod["router"]["bias"]),
            **{k: tr.tp.shard(torch.from_numpy(mod[k]), 0)
               for k in ("w_up", "b_up", "w_down", "b_down")}})
        layer.tokens = TokenLayout(batch=4, row0=rows.start, chunk=0, chunks=1, writes=True,
                                   replicas=1, group=mesh.data_group)
        x = torch.from_numpy(data[f"{name}:x"][rows]).to(torch.bfloat16)
        with torch.no_grad():
            dispatch, combine, aux = layer.route(x)
            y, _ = layer(x)
        dist.all_reduce(aux, group=mesh.data_group)
        e0, el = tr.tp.part(cfg.n_experts)
        experts = slice(e0, e0 + el)
        tokens = slice(rows.start * 32, rows.stop * 32)
        d_ref = data[f"{name}:dispatch"][tokens, experts]
        c_ref = data[f"{name}:combine"][tokens, experts]
        found[f"{name}_routes"] = {
            "shape": list(dispatch.shape), "ref_shape": list(d_ref.shape),
            "dispatch_equal": bool(np.array_equal(dispatch.float().numpy(), d_ref)),
            "routed": float(dispatch.float().sum()),
            # bf16 gates: within one bf16 ulp of each
            "combine_close": bool(np.allclose(combine.float().numpy(), c_ref, rtol=2 ** -8,
                                              atol=0)),
            "y_err": float(np.abs(y.float().numpy() - data[f"{name}:y"][rows]).max()),
            "aux": float(aux)}
        state = tr.init(seed=0)
        if trajectory is None:
            trajectory = _arrival(out / "moe.npz")
        found[f"{name}_losses"] = _train(tr, state, data[f"{name}:tokens"],
                                         before=lambda i: _params(trajectory, f"{name}:p{i}"))
        params.update({f"{name}:{n}": v for n, v in _local(state.model).items()})
    return found, params


def _arrival(path: Path, timeout_s: float = 240.0):
    """The ``.npz`` at ``path`` once the test has written it (it renames a
    whole file into place)."""
    deadline = time.monotonic() + timeout_s
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not arrive in {timeout_s} s")
        time.sleep(0.05)
    return np.load(path)


def _params(data, prefix: str) -> dict:
    """The port state_dict under ``prefix`` of the flattened ``data``."""
    return {k[len(prefix) + 1:]: torch.from_numpy(data[k]) for k in data.files
            if k.startswith(prefix + "/")}


def _whole(state) -> dict:
    """Every value of a state's parameters and adamw moments, whole
    (gathered over tp), with the step counts."""
    model, adamw = state.model, state.optimizer.adamw
    tp = getattr(model, "tp", NO_TP)
    named = dict(model.named_parameters())
    out = {f"model.{n}": t for n, t in model.state_dict().items()}
    for key in ("exp_avg", "exp_avg_sq"):
        out.update({f"{key}.{n}": t for n, t in unshard_state_dict(
            {n: adamw.state[p][key] for n, p in named.items()}, tp).items()})
    out.update({f"step.{n}": adamw.state[p]["step"] for n, p in named.items()})
    whole = unshard_state_dict({n[6:]: t for n, t in out.items() if n.startswith("model.")}, tp)
    out.update({f"model.{n}": t for n, t in whole.items()})
    return out


def _restore_checks(src, state, dst, path, next_tokens) -> dict:
    """Restore ``path`` and reshard ``state`` onto ``dst``: every value
    equal to ``state``'s after unsharding, the update count, and the next
    step's loss beside ``src``'s on the same batch."""
    ref = _whole(state)
    restored = restore_state(dst, path)
    moved = reshard_state(dst, state)
    equal = all(torch.equal(ref[k], w[k]) for w in (_whole(restored), _whole(moved)) for k in ref)
    count = restored.optimizer.count()
    _, ref_loss = src.step(state, src.to_device(next_tokens))
    _, loss = dst.step(restored, dst.to_device(next_tokens))
    return {"xmesh_values_equal": equal, "xmesh_count": count,
            "xmesh_loss": float(loss), "xmesh_ref_loss": float(ref_loss),
            "xmesh_split": sorted(n for n, p in restored.model.named_parameters()
                                  if p.shape != dict(state.model.named_parameters())[n].shape)}


def _two(data, out: Path):
    found = {}
    # 1. a dp = 2 checkpoint onto dp 1 x tp 2
    src = ShardedTrainer("transformer-tiny", make_mesh(dp=2, device="cpu"), **XMESH_KW)
    tokens = data["dense:tokens"]
    state, _ = src.step(src.init(seed=0), src.to_device(tokens[0]))
    path = save_state(state, out / "xmesh2_ckpt")
    dst = ShardedTrainer("transformer-tiny", make_mesh(dp=1, tp=2, device="cpu"), **XMESH_KW)
    found.update(_restore_checks(src, state, dst, path, tokens[1]))
    # and back: a dp 1 x tp 2 state (each shard written once) restored onto
    # dp 2, and the same move in memory (the shards gathered)
    state, _ = dst.step(restore_state(dst, path), dst.to_device(tokens[1]))
    back = save_state(state, out / "back_ckpt")
    found["back"] = _restore_checks(dst, state, src, back, tokens[2])

    # 2. the profiler's measured tp point, its errors, and a dp curve whose
    # k = 1 point is measured on a mesh of rank 0 alone
    cache = CurveCache(out / "curves.json")
    kw = dict(batch_size=2, seq_len=32, cache=cache, device="cpu")
    curve = profile_model("transformer-tiny", ks=(2, 64), tp=2, **kw)
    found["tp_step_2"] = curve.step_time(2)
    for key, call in (("divisible", dict(ks=(1, 2), tp=2)), ("exceeds", dict(ks=(8,), tp=4))):
        try:
            profile_model("transformer-tiny", **call, **kw)
            found[key] = None
        except ValueError as e:
            found[key] = str(e)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        profile_model("transformer-tiny", ks=(1, 2, 64), batch_size=3, seq_len=32,
                      cache=cache, device="cpu")
    found["warnings"] = [str(w.message) for w in seen if "not divisible by dp" in str(w.message)]
    return found, {}
