"""Tensor parallelism over processes on the CPU: gloo ranks (the rank body
is ``tests/torch_tp_worker.py``, which imports no JAX) against the JAX
trainer on the same mesh of the conftest's virtual CPU devices, which runs
in this process.  Two spawns, of four ranks and of two.

Four ranks:

1. ``transformer-tiny`` on dp 2 x tp 2, dense and ``flash_attn``, and
   ring-flash on dp 1 x sp 2 x tp 2, three steps from the JAX trainer's
   parameters on the same batches: each loss within 5e-3 of the JAX
   trainer's (``tests/test_torch_train.py``'s bound), each rank's shard of
   every parameter's update within UPDATE_RTOL of the matching slice of
   JAX's (relative L2), every replicated parameter equal on the tp ranks
   and every parameter equal on the dp ranks, to the bit;
2. ``moe-tiny`` and ``moe-top2-tiny`` on dp 2 x tp 2: ``MoeMlp`` given
   flax's input and parameters, each rank its rows and its two experts,
   puts every choice in the flax module's slot (the global batch's: the
   counts exchanged over dp), combine within one bf16 ulp of each gate,
   the output within one bf16 ulp at its scale and the summed aux shares
   within AUX_RTOL of the aux; then three trainer steps in lockstep with
   the JAX trainer on dp 2 x tp 2 (the port takes the JAX trainer's
   parameters before each step, as ``tests/test_torch_moe.py`` does: a
   route near a tie flips on a bf16 ulp), each loss within 5e-3 and the
   last update within MOE_UPDATE_RTOL;
3. a dp 4 flash checkpoint (warmup, decay, clip) restored onto
   dp 2 x tp 2: every value equal once unsharded, in memory too
   (``reshard_state``), the update count 1, the next loss within rtol
   2e-4 of the dp 4 trainer's (the JAX cross-mesh test's bound);
4. ``train --tp 2`` on the group (an MoE model): rank 0 prints the
   summary, ``"tp": 2`` in its mesh.

Two ranks: a dp 2 checkpoint onto dp 1 x tp 2 (as 3.), and a dp 1 x tp 2
checkpoint back onto dp 2 (the shards written once, read whole; in memory
the shards gathered); ``profile_model``
with ``tp=2, ks=(2, 64)`` (the key ``transformer-tiny@sp1tp2``, "tp=2" in
its source, a measured point at 2), its "divisible" and "exceeds" errors,
and a dp curve whose k = 1 point is measured on a mesh of rank 0 alone
while rank 1 waits, with the batch round-down warning at k = 2.
"""

import json
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import torch_tp_worker  # noqa: E402
from gpuschedule_tpu.models.config import MODEL_CONFIGS as JAX_CONFIGS  # noqa: E402
from gpuschedule_tpu.models.transformer import MoeMlp as JaxMoeMlp  # noqa: E402
from gpuschedule_tpu.parallel import ShardedTrainer as JaxTrainer  # noqa: E402
from gpuschedule_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from gpuschedule_tpu_torch.convert import params_from_jax  # noqa: E402
from gpuschedule_tpu_torch.data import synthetic_lm_batches  # noqa: E402
from gpuschedule_tpu_torch.models import MODEL_CONFIGS  # noqa: E402
from gpuschedule_tpu_torch.parallel.tp import Tp, param_partition_spec  # noqa: E402

TIMEOUT_S = 300
LOSS_ATOL = 5e-3
# relative L2 distance of a rank's shard of a parameter's update over the
# three steps from the same slice of the JAX trainer's update: the bound of
# tests/test_torch_ring_dist.py (bf16 rounding moves rare tokens' rows)
UPDATE_RTOL = 0.3
# the same for the MoE's last lockstep update: tests/test_torch_moe.py's
MOE_UPDATE_RTOL = 0.6
MODULE_ATOL = 2 ** -8
AUX_RTOL = 1e-5


def _flat(tree, prefix):
    """``{prefix/flax/path: array}`` of a flax tree."""
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]
    return {prefix + "/" + "/".join(getattr(k, "key", str(k)) for k in path): np.asarray(v)
            for path, v in leaves}


def _batches(seq):
    return np.stack(list(synthetic_lm_batches(batch_size=4, seq_len=seq, vocab=8192,
                                              num_batches=3)))


def _spawn(world, tmp_path, data):
    return mp.start_processes(
        torch_tp_worker.run, nprocs=world, join=False, start_method="spawn",
        args=(world, str(tmp_path / f"store{world}"), str(data), str(tmp_path)))


def _wait(ctx, deadline):
    """Join the spawned ranks by ``deadline``; a rank that raised raises
    here, and ranks still running at the deadline are stopped."""
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise AssertionError(f"the ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


def _jax_moe(cfg, x):
    """flax ``MoeMlp`` on ``x``: (params, y, aux, dispatch, combine), the
    dispatch and combine read from its einsums while tracing."""
    layer = JaxMoeMlp(cfg)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    params = {"params": jax.device_get(jax.jit(layer.init)(jax.random.PRNGKey(1), xb)["params"])}
    einsum = jnp.einsum

    def run(params, xb):
        seen = {}

        def spy(spec, *ops, **kw):
            if spec in ("td,tec->ecd", "ecd,tec->td"):
                seen[spec] = ops[1].astype(jnp.float32)
            return einsum(spec, *ops, **kw)

        jnp.einsum = spy
        try:
            y, mods = layer.apply(params, xb, mutable=["moe_losses"])
        finally:
            jnp.einsum = einsum
        return y.astype(jnp.float32), mods, seen["td,tec->ecd"], seen["ecd,tec->td"]

    y, mods, dispatch, combine = jax.device_get(jax.jit(run)(params, xb))
    aux = float(jax.tree_util.tree_leaves(mods["moe_losses"])[0])
    return params, np.asarray(y), aux, np.asarray(dispatch), np.asarray(combine)


def _shard_update_rel(name, got, before, after, tp):
    """Relative L2 distance of a rank's update of ``name`` from its slice
    of the JAX update ``after - before``."""
    dim = param_partition_spec(name, before.dim())
    ref = (tp.shard(after, dim) - tp.shard(before, dim)).numpy()
    update = got - tp.shard(before, dim).numpy()
    return float(np.linalg.norm(update - ref) / np.linalg.norm(ref))


def _steps(jt, batches, started):
    """The JAX trainer's losses on ``batches`` from its seed-0 state, and
    its parameters before each step and after the last as the port's
    state_dicts; ``started`` gets its initial parameters (a flax tree)."""
    cfg = MODEL_CONFIGS[jt.cfg.name]
    try:
        state = jt.init(seed=0)
    except BaseException as e:
        started.set_exception(e)
        raise
    started.set_result(jax.device_get(state[0]))
    losses, trajectory = [], [params_from_jax(jax.device_get(state[0]), cfg)]
    for tokens in batches:
        state, loss = jt.step(state, jnp.asarray(tokens))
        losses.append(float(loss))
        trajectory.append(params_from_jax(jax.device_get(state[0]), cfg))
    return losses, trajectory


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two-rank run, started with the module so that it runs while the
    four-rank test's JAX trainers compile: (its processes, its directory).
    The four-rank test requests it for that alone; the two-rank test
    joins it."""
    out = tmp_path_factory.mktemp("two")
    np.savez(out / "data.npz", **{"dense:tokens": _batches(32)})
    ctx = _spawn(2, out, out / "data.npz")
    yield ctx, out
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()


def test_tp_trainers_match_jax_on_four_gloo_ranks(tmp_path, two_ranks):
    mesh22 = jax_make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    kw = dict(batch_size=4, learning_rate=3e-3)
    data, moe_ref = {}, {}
    # the MoE module given flax's inputs first: its einsum spy is
    # process-wide, so it runs before any thread traces
    for name in ("moe-tiny", "moe-top2-tiny"):
        x = np.random.default_rng(0).standard_normal((4, 32, 128)).astype(np.float32)
        params, y, aux, dispatch, combine = _jax_moe(JAX_CONFIGS[name], x)
        data.update(_flat(params["params"], f"{name}:mod"))
        data.update({f"{name}:x": x, f"{name}:y": y, f"{name}:dispatch": dispatch,
                     f"{name}:combine": combine})
        moe_ref[name] = (aux, dispatch)
    jax_runs = {
        "dense": JaxTrainer("transformer-tiny", mesh22, seq_len=32, **kw),
        "flash": JaxTrainer("transformer-tiny", mesh22, seq_len=32, flash_attn=True, **kw),
        # the dense ring: the port's ring-flash is held to the JAX ring-flash
        # in tests/test_torch_ring_dist.py; here the ring's composition with tp
        "ring": JaxTrainer("transformer-tiny", jax_make_mesh(dp=1, sp=2, tp=2,
                                                             devices=jax.devices()[:4]),
                           seq_len=64, ring_attn=True, seq_shard=True, **kw),
        "moe-tiny": JaxTrainer("moe-tiny", mesh22, seq_len=32, **kw),
        "moe-top2-tiny": JaxTrainer("moe-top2-tiny", mesh22, seq_len=32, **kw),
    }
    for key in jax_runs:
        data[f"{key}:tokens"] = _batches(64 if key == "ring" else 32)

    # the JAX trainers on threads (XLA compiles without the interpreter
    # lock); the ranks start once the dense, flash and ring trainers have
    # their initial parameters, and take the MoE trainers' parameters
    # before each of their steps (lockstep) from moe.npz when it comes
    deadline = time.monotonic() + TIMEOUT_S
    ctx = None
    try:
        with ThreadPoolExecutor(len(jax_runs)) as pool:
            started = {key: Future() for key in jax_runs}
            runs = {key: pool.submit(_steps, jt, data[f"{key}:tokens"], started[key])
                    for key, jt in jax_runs.items()}
            for key in ("dense", "flash", "ring"):
                data.update(_flat(started[key].result(timeout=TIMEOUT_S), f"{key}:p0"))
            np.savez(tmp_path / "data.npz", **data)
            ctx = _spawn(4, tmp_path, tmp_path / "data.npz")
            moe = {}
            for name in ("moe-tiny", "moe-top2-tiny"):
                moe.update({f"{name}:p{i}/{n}": t.numpy() for i, sd in
                            enumerate(runs[name].result()[1][:3]) for n, t in sd.items()})
            np.savez(tmp_path / "moe.partial.npz", **moe)
            (tmp_path / "moe.partial.npz").rename(tmp_path / "moe.npz")
            results = {key: f.result() for key, f in runs.items()}
    finally:
        if ctx is not None:
            _wait(ctx, deadline)

    found = [json.loads((tmp_path / f"w4rank{r}.json").read_text()) for r in range(4)]
    ranks = [np.load(tmp_path / f"w4rank{r}.npz") for r in range(4)]
    assert sorted(tuple(f["coords"]) for f in found) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for key in ("dense", "flash", "ring"):
        losses, trajectory = results[key]
        for f, params in zip(found, ranks):
            np.testing.assert_allclose(f[f"{key}_losses"], losses, atol=LOSS_ATOL, rtol=0)
            dp, _, t = f[f"{key}_coords"]
            tp = Tp(2, t)
            for name, p0 in trajectory[0].items():
                got = params[f"{key}:{name}"]
                # every rank of a tp coordinate holds the same shard; a
                # replicated parameter is the same on every rank
                peers = [o for g, o in zip(found, ranks) if g[f"{key}_coords"][2] == t
                         or param_partition_spec(name, p0.dim()) is None]
                for other in peers:
                    np.testing.assert_array_equal(other[f"{key}:{name}"], got, err_msg=name)
                if name.endswith("attn.key.bias"):
                    continue  # its exact gradient is 0: adam moves it on rounding noise
                rel = _shard_update_rel(name, got, p0, trajectory[-1][name], tp)
                assert rel < UPDATE_RTOL, (key, name, t, rel)
    for name, (aux, dispatch) in moe_ref.items():
        losses, trajectory = results[name]
        for f, params in zip(found, ranks):
            routes = f[f"{name}_routes"]
            assert routes["shape"] == routes["ref_shape"] == [64, 2, dispatch.shape[2]]
            assert routes["dispatch_equal"] and routes["routed"] > 0, routes
            assert routes["combine_close"] and routes["y_err"] < MODULE_ATOL, routes
            assert routes["aux"] == pytest.approx(aux, rel=AUX_RTOL)
            np.testing.assert_allclose(f[f"{name}_losses"], losses, atol=LOSS_ATOL, rtol=0)
            tp = Tp(2, f["coords"][1])
            for pname, before in trajectory[2].items():
                if pname.endswith("attn.key.bias"):
                    continue
                rel = _shard_update_rel(pname, params[f"{name}:{pname}"], before,
                                        trajectory[3][pname], tp)
                assert rel < MOE_UPDATE_RTOL, (name, pname, rel)
    for f in found:
        assert f["xmesh_values_equal"] and f["xmesh_count"] == 1
        np.testing.assert_allclose(f["xmesh_loss"], f["xmesh_ref_loss"], rtol=2e-4)
        assert "embed.embedding" in f["xmesh_split"] and "pos_embed" not in f["xmesh_split"]
        assert f["cli_rc"] == 0
    assert (tmp_path / "xmesh_ckpt" / ".metadata").exists()
    lines = [f["cli_out"].strip() for f in found]
    assert sum(bool(line) for line in lines) == 1
    summary = json.loads(next(line for line in lines if line))
    assert summary["mesh"] == {"pp": 1, "dp": 2, "sp": 1, "tp": 2}
    assert summary["model"] == "moe-tiny" and np.isfinite(summary["last_loss"])


def test_tp_restore_and_profile_on_two_gloo_ranks(two_ranks):
    ctx, tmp_path = two_ranks
    _wait(ctx, time.monotonic() + TIMEOUT_S)
    found = [json.loads((tmp_path / f"w2rank{r}.json").read_text()) for r in range(2)]
    for f in found:
        assert f["xmesh_values_equal"] and f["xmesh_count"] == 1
        np.testing.assert_allclose(f["xmesh_loss"], f["xmesh_ref_loss"], rtol=2e-4)
        back = f["back"]
        assert back["xmesh_values_equal"] and back["xmesh_count"] == 2
        assert back["xmesh_split"] == f["xmesh_split"]  # the same parameters, whole here
        np.testing.assert_allclose(back["xmesh_loss"], back["xmesh_ref_loss"], rtol=2e-4)
        assert f["tp_step_2"] > 0
        assert "divisible" in f["divisible"] and "sp*tp*pp=2" in f["divisible"]
        assert "exceeds the 2 available devices" in f["exceeds"]
        assert f["warnings"] == ["batch 3 not divisible by dp=2: measuring batch 2 instead — "
                                 "step times at this k are NOT comparable to ks that kept the "
                                 "full batch; use a batch size divisible by every profiled k"]
    meta = json.loads((tmp_path / "curves.json").read_text())
    tp_entry = meta["transformer-tiny@sp1tp2"]
    assert "tp=2" in tp_entry["source"] and "measured<= 2 chips" in tp_entry["source"]
    assert "2" in set(tp_entry["points"]) and "64" in set(tp_entry["points"])
    dp_entry = meta["transformer-tiny"]
    assert {"1", "2", "64"} <= set(dp_entry["points"])
