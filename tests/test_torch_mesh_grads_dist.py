"""Gradients over meshes on the CPU: four gloo ranks (the rank body is
``tests/torch_mesh_grads_worker.py``, which imports no JAX), one spawn.

1. The gathered-sequence sp path (``seq_shard`` without ``ring_attn``:
   dense attention over k and v gathered over sp) on dp 2 x sp 2 against
   the JAX trainer with ``seq_shard=True`` on the same mesh of the
   conftest's virtual CPU devices, from its parameters on the same three
   global batches: each loss within LOSS_RTOL of the JAX trainer's, the
   gradients after one backward within JAX_GRAD_RTOL (relative L2) of
   ``jax.grad`` of its loss on its sharded batch, and within GRAD_TOL of
   each tensor's largest entry of the port's one-rank model's.
2. tp's gradients on dp 2 x tp 2: after one backward of
   ``transformer-tiny`` on the same parameters and batch, each rank's
   gradient of each parameter within GRAD_TOL (relative L2) of the one-rank
   model's (a split parameter slice by slice, a replicated one whole):
   tp's row-parallel sums round other than one product does, and a small
   gradient's entries (a query bias) move 1.9% of its largest entry here
   (on the card at full width 2.04e-2 relative L2 at attention's q and k
   kernels: chip_smoke's TP_GRAD_RTOL).  The check bites: with a replicated parameter's gradient scaled
   by tp on one tp rank (a monkeypatch of the gradient sum, in the rank
   body), that rank's error at that parameter is far past GRAD_TOL.  The
   MoE (``moe-tiny``) is held where a route cannot flip: block 0's module
   over dp 2 x tp 2 against the one-rank model's, on that model's input
   to it, each parameter's and the input's gradient within GRAD_TOL
   (relative L2).
"""

import json
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import torch_mesh_grads_worker as worker  # noqa: E402
from gpuschedule_tpu.parallel import ShardedTrainer as JaxTrainer  # noqa: E402
from gpuschedule_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from gpuschedule_tpu_torch.convert import params_from_jax  # noqa: E402
from gpuschedule_tpu_torch.data import synthetic_lm_batches  # noqa: E402
from gpuschedule_tpu_torch.models import MODEL_CONFIGS  # noqa: E402

TIMEOUT_S = 300
WORLD = 4
LOSS_RTOL = 5e-3
GRAD_TOL = 2e-2  # chip_smoke's GRAD_TOL: the sp path's max abs error over the largest
# entry; tp's relative L2 error
# relative L2 against jax.grad: JAX's gradient is defined to its bf16 noise
# (tests/test_torch_pipeline_dist.py)
JAX_GRAD_RTOL = 5e-2


def _flat(tree, prefix):
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]
    return {prefix + "/" + "/".join(getattr(k, "key", str(k)) for k in path): np.asarray(v)
            for path, v in leaves}


def test_gathered_sp_and_tp_gradients_on_four_gloo_ranks(tmp_path):
    deadline = time.monotonic() + TIMEOUT_S
    vocab = MODEL_CONFIGS["transformer-tiny"].vocab
    batches = np.stack(list(synthetic_lm_batches(batch_size=worker.BATCH, seq_len=worker.SEQ,
                                                 vocab=vocab, num_batches=4, seed=2)))
    mesh = jax_make_mesh(dp=2, sp=2, devices=jax.devices()[:4])
    jt = JaxTrainer("transformer-tiny", mesh, batch_size=worker.BATCH, seq_len=worker.SEQ,
                    seq_shard=True, learning_rate=3e-3)
    state = jt.init(seed=0)
    np.savez(tmp_path / "data.npz", **_flat(state[0], "sp:p0"), **{
        "sp:tokens": batches[:3], "tp:tokens": batches[3]})
    ctx = mp.start_processes(worker.run, nprocs=WORLD, join=False, start_method="spawn",
                             args=(WORLD, str(tmp_path / "store"), str(tmp_path / "data.npz"),
                                   str(tmp_path)))
    try:
        def loss_fn(params, tokens):
            logits = jt.model.apply(params, tokens)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :-1, :], tokens[:, 1:]).mean()

        with mesh:
            tokens = jax.device_put(jnp.asarray(batches[0]), jt.batch_sharding)
            grads = jax.device_get(jax.jit(jax.grad(loss_fn))(state[0], tokens))
        losses = []
        for b in batches[:3]:
            state, loss = jt.step(state, jnp.asarray(b))
            losses.append(float(loss))
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            assert time.monotonic() < deadline, f"the ranks did not finish in {TIMEOUT_S} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()

    found = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(WORLD)]
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(WORLD)]
    ref = params_from_jax(grads, MODEL_CONFIGS["transformer-tiny"])
    top = max(float(np.linalg.norm(r.numpy())) for r in ref.values())
    assert sorted(tuple(f["sp"]["coords"]) for f in found) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for f, arrays in zip(found, ranks):
        sp = f["sp"]
        assert sp["attn"] == "gathered_attention"
        assert sp["local_batch"] == [worker.BATCH // 2, worker.SEQ // 2 + (sp["coords"][1] == 0)]
        np.testing.assert_allclose(sp["losses"], losses, rtol=LOSS_RTOL)
        assert sp["grad_loss"] == pytest.approx(losses[0], rel=LOSS_RTOL)
        assert sp["one_rank_err"] < GRAD_TOL, sp
        for name, r in ref.items():
            r = r.numpy()
            scale = top if name.endswith("attn.key.bias") else np.linalg.norm(r)
            err = float(np.linalg.norm(arrays[f"sp:grad:{name}"] - r)) / scale
            assert err < JAX_GRAD_RTOL, (name, err)
    for f in found:
        cell = f["tp"]
        assert max(cell["clean"].values()) < GRAD_TOL, cell["clean"]
        worst = max(cell["mutated"], key=cell["mutated"].get)
        if cell["tp"] == 1:
            assert worst == worker.MUTATED and cell["mutated"][worst] > 0.5, cell["mutated"]
        else:
            assert cell["mutated"] == cell["clean"]
        assert max(f["moe"].values()) < GRAD_TOL, f["moe"]
        assert {"input", "blocks.0.moe.router.kernel", "blocks.0.moe.w_up"} <= set(f["moe"])
