"""The multi-rank path on the CPU: four gloo processes, a dp = 2 x sp = 2
mesh (``make_mesh`` on ``init_device_mesh``), one spawn.

Each rank (``tests/torch_ring_worker.py``) checks:

1. the process-group ring (``batch_isend_irecv`` on the mesh's sp group)
   against the in-process ring on the same inputs, dense and flash, causal
   and full, values and gradients: the same chunk ops in the same order, so
   equal to the bit;
2. three ``ShardedTrainer(ring_attn=True, flash_attn=True)`` steps from the
   JAX trainer's parameters on the same global batches: the losses agree
   with the JAX trainer's on a dp = 2 x sp = 2 mesh of the virtual CPU
   devices within 5e-3 (``tests/test_torch_train.py``'s bound: bf16 logits
   that differ by an ulp, averaged over the batch), on every rank.  The
   loss is all-reduced, so the ranks agree on it by construction; the
   parameters after the steps show the gradient sum: equal on every rank,
   and each one's update close to the JAX trainer's (``UPDATE_RTOL``);
3. the ``train`` CLI on the same group (``--sp 2 --ring-attn
   --flash-attn``): rank 0 prints the summary line, with the mesh's shape;
4. an MoE model (``moe-top2-tiny``, ring-flash) over the four ranks:
   block 0's routes, given the one-rank model's input to that block, are
   the one-rank module's for each rank's rows and sequence chunk (the
   global batch's slots), three steps leave the same parameters on every
   rank, and the first loss is within 5e-3 of the one-rank model's on the
   same batch;
5. three ``resnet-tiny`` steps over dp = 2 (each rank's two rows of images
   and labels; the sp ranks are replicas) from the JAX trainer's
   parameters: the losses agree with the JAX trainer's on the same mesh
   within 5e-3, and the parameters after them are the same on every rank;
6. the cross-mesh restore: a flash step at dp = 4 with warmup, decay and
   clip, ``save_state`` by the four ranks, ``restore_state`` onto a
   dp = 2 x sp = 2 ring-flash trainer: every value equal (so is
   ``reshard_state``'s move between the two meshes), the update count 1,
   and the next step's loss, fed by ``prefetch_to_device`` (each rank's
   rows and chunk, equal to ``to_device``'s), within rtol 2e-4 of the
   dp = 4 trainer's next (the JAX cross-mesh test's bound; the ring merges
   the chunks' f32 partial sums in another order).

The JAX trainer's steps run in this process while the ranks run.
"""

import json
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import torch_ring_worker  # noqa: E402
from gpuschedule_tpu.parallel import ShardedTrainer as JaxTrainer  # noqa: E402
from gpuschedule_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from gpuschedule_tpu_torch.convert import params_from_jax  # noqa: E402
from gpuschedule_tpu_torch.data import synthetic_lm_batches  # noqa: E402

TIMEOUT_S = 300
MODEL = "transformer-tiny"
# relative L2 distance of a parameter's update over the three steps from the
# JAX trainer's.  adam normalizes each gradient entry, so entries whose
# gradients are small (embedding rows of rare tokens) move on bf16 rounding;
# the largest seen is 0.16 (the embedding), where dk/dv accumulators left
# one hop short of home give more than 1 on most parameters.
UPDATE_RTOL = 0.3


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


def test_process_group_ring_and_trainer_on_four_gloo_ranks(tmp_path):
    kw = dict(batch_size=4, seq_len=64, learning_rate=3e-3, seq_shard=True, ring_attn=True,
              flash_attn=True)
    jt = JaxTrainer(MODEL, jax_make_mesh(dp=2, sp=2, devices=jax.devices()[:4]), **kw)
    state = jt.init(seed=0)
    batches = np.stack(list(synthetic_lm_batches(batch_size=4, seq_len=64, vocab=8192,
                                                 num_batches=3)))
    params = params_from_jax(jax.device_get(state[0]), jt.cfg)
    rng = np.random.default_rng(0)
    data = {n: rng.standard_normal((4, 64, 2, 32)).astype(np.float32) for n in "qkvg"}
    data["tokens"] = batches
    data.update({f"p:{name}": t.numpy() for name, t in params.items()})
    cnn = JaxTrainer("resnet-tiny", jax_make_mesh(dp=2, sp=2, devices=jax.devices()[:4]),
                     batch_size=4, learning_rate=3e-3)
    cnn_state = cnn.init(seed=0)
    data["images"] = rng.standard_normal((3, 4, 32, 32, 3)).astype(np.float32)
    data["labels"] = rng.integers(0, 100, size=(3, 4)).astype(np.int32)
    data.update({f"cnn:{name}": t.numpy() for name, t in
                 params_from_jax(jax.device_get(cnn_state[0]), cnn.cfg).items()})
    np.savez(tmp_path / "data.npz", **data)

    deadline = time.monotonic() + TIMEOUT_S
    ctx = mp.start_processes(
        torch_ring_worker.run, nprocs=torch_ring_worker.WORLD, join=False,
        start_method="spawn",
        args=(str(tmp_path / "store"), str(tmp_path / "data.npz"), str(tmp_path)),
    )
    try:
        ref = []
        for tokens in batches:  # the JAX trainer's steps, while the ranks run
            state, loss = jt.step(state, jnp.asarray(tokens))
            ref.append(float(loss))
        ref_params = params_from_jax(jax.device_get(state[0]), jt.cfg)
        cnn_ref = []
        for images, labels in zip(data["images"], data["labels"]):
            cnn_state, loss = cnn.step(cnn_state, (jnp.asarray(images), jnp.asarray(labels)))
            cnn_ref.append(float(loss))
    finally:
        _wait(ctx, deadline)

    # the parameters after the steps: the same on every rank, to the bit, and
    # each parameter's update within UPDATE_RTOL of the JAX trainer's
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(torch_ring_worker.WORLD)]
    for name, p0 in params.items():
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[name], ranks[0][name], err_msg=name)
        if name.endswith("attn.key.bias"):
            continue  # its exact gradient is 0: adam moves it on rounding noise
        ref_update = ref_params[name].numpy() - p0.numpy()
        update = ranks[0][name] - p0.numpy()
        rel = np.linalg.norm(update - ref_update) / np.linalg.norm(ref_update)
        assert rel < UPDATE_RTOL, (name, rel)

    found = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(torch_ring_worker.WORLD)]
    assert sorted(tuple(f["coords"]) for f in found) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for f in found:
        assert f["rings"] == {key: 0.0 for key in
                              ("flash-causal", "flash-full", "dense-causal", "dense-full")}
        # dp rows and the sp chunk, plus the next token as the chunk's last label
        assert f["local_tokens"] == [2, 33 if f["coords"][1] == 0 else 32]
        np.testing.assert_allclose(f["losses"], ref, atol=5e-3, rtol=0)
        assert f["cli_rc"] == 0
        assert f["moe_routes_equal"]
        assert f["moe_losses"] == found[0]["moe_losses"] and np.isfinite(f["moe_losses"]).all()
        assert abs(f["moe_losses"][0] - f["moe_one_rank_loss"]) < 5e-3
        assert f["cnn_rows"] == [[2, 32, 32, 3], [2]]
        np.testing.assert_allclose(f["cnn_losses"], cnn_ref, atol=5e-3, rtol=0)
        assert f["xmesh_values_equal"] and f["xmesh_count"] == 1
        assert f["prefetch_equals_to_device"]
        np.testing.assert_allclose(f["xmesh_loss"], f["xmesh_ref_loss"], rtol=2e-4)
    assert (tmp_path / "xmesh_ckpt" / ".metadata").exists()
    for name in (n for n in ranks[0].files if n.startswith(("cnn:", "moe:"))):
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[name], ranks[0][name], err_msg=name)
    lines = [f["cli_out"].strip() for f in found]
    rank0 = next(line for f, line in zip(found, lines) if f["coords"] == [0, 0])
    assert sum(bool(line) for line in lines) == 1
    summary = json.loads(rank0)
    assert summary["mesh"] == {"pp": 1, "dp": 2, "sp": 2, "tp": 1}
    assert summary["steps"] == 2 and np.isfinite(summary["last_loss"])
