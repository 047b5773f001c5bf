"""The pipeline over processes on the CPU: four gloo ranks (the rank body is
``tests/torch_pipeline_worker.py``, which imports no JAX) against the JAX
``PipelinedLM`` on (pp, dp) meshes of the conftest's virtual CPU devices,
which runs in this process while the ranks run.  One spawn.

Each case takes the JAX pipeline's initial parameters (``convert.py``
carries each stage's slice to its ranks) and the same three global
batches:

- ``dense``: ``transformer-tiny`` on pp 2 x dp 2, M = 4, gpipe;
- ``dense_dp1``: the same on pp 2 x dp 1 (the first two ranks), M = 2;
- ``flash``: ``flash_attn`` (the plain twins of K1-K3 on the CPU) on
  pp 2 x dp 2, M = 2, remat;
- ``moe``: ``moe-top2-tiny`` (its aux, z-loss and top-2 routes per
  microbatch and dp column) on pp 2 x dp 2, M = 2.

Each loss of three steps within LOSS_RTOL of the JAX pipeline's, and the
gradients after one backward on the first batch, every stage's blocks,
the embedding's and the head's on every rank, within JAX_GRAD_RTOL
(relative L2) of JAX's (``jax.grad`` of its pipelined loss), and within GRAD_RTOL of
each tensor's largest entry of the port's sequential model's
(``reference_loss(per_microbatch=True)`` on the whole model).  On the dense
case the remat schedule's loss, gradients and first update equal the gpipe
schedule's to the bit; a checkpoint saved after one step and restored
resumes with the straight run's losses to the bit, and restores onto a
dp 4 trainer of the whole model too (its next loss within 2e-4, the JAX
cross-mesh test's bound).  ``train --pp 2 --microbatches 4 --pp-schedule
remat`` runs on the four ranks, saves, and resumes at step 3;
``profile_model(pp=2)`` writes the ``model@sp1tp1pp2`` key with a point
measured on two ranks (the others wait), and the pipeline's refusals are
the reference's.
"""

import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import torch_pipeline_worker as worker  # noqa: E402
from gpuschedule_tpu.parallel import PipelinedLM as JaxPipelinedLM  # noqa: E402
from gpuschedule_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from gpuschedule_tpu_torch.convert import params_from_jax  # noqa: E402
from gpuschedule_tpu_torch.data import synthetic_lm_batches  # noqa: E402
from gpuschedule_tpu_torch.models import MODEL_CONFIGS  # noqa: E402

TIMEOUT_S = 300
LOSS_RTOL = 5e-3
# a gradient's error against the port's sequential model on the same
# shares: max abs over each tensor's largest entry
GRAD_RTOL = 1e-2
# ... and against JAX's, relative L2 of each tensor: JAX's gradient is defined
# to its bf16 noise only, its own pipelined and sequential gradients of one
# tensor differing by up to 3.4% (relative L2; transformer-tiny, M 4, pp 2:
# the query bias; pos_embed 1.65%), the port's sequential model's by up to
# 2.2% from JAX's pipelined (a factor fault moves a tensor by 50% or more)
JAX_GRAD_RTOL = 5e-2
# the MoE's: tests/test_torch_moe.py's MOE_GRAD_RTOL (a route near a tie flips
# on a bf16 ulp, and a flipped token moves the router's gradient)
MOE_JAX_GRAD_RTOL = 0.1
WORLD = 4


def _flat(tree, prefix):
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]
    return {prefix + "/" + "/".join(getattr(k, "key", str(k)) for k in path): np.asarray(v)
            for path, v in leaves}


def _jax_run(plm, params, batches):
    """(the losses of three steps from ``params``, the gradients at
    ``params`` on batch 0): the JAX pipeline's step (its loss's
    ``value_and_grad``, then its optimizer) as two programs, the gradient
    program run once a step."""
    import optax

    grad_fn = jax.jit(jax.value_and_grad(plm._loss_fn))
    update = jax.jit(lambda g, o, p: (lambda u, o: (optax.apply_updates(p, u), o))(
        *plm.tx.update(g, o, p)))
    opt_state, losses, first = plm.tx.init(params), [], None
    with plm.mesh:
        for tokens in batches:
            loss, grads = grad_fn(params, jnp.asarray(tokens))
            first = jax.device_get(grads) if first is None else first
            params, opt_state = update(grads, opt_state, params)
            losses.append(float(loss))
    return losses, first


def _wait(ctx, deadline):
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise AssertionError(f"the ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


def test_pipeline_matches_jax_on_four_gloo_ranks(tmp_path):
    deadline = time.monotonic() + TIMEOUT_S
    data, jax_runs, inits = {}, {}, {}
    for case, (model, dp, m, flash, schedule) in worker.CASES.items():
        mesh = jax_make_mesh(pp=2, dp=dp, devices=jax.devices()[:2 * dp])
        plm = JaxPipelinedLM(model, mesh, batch_size=worker.BATCH, seq_len=worker.SEQ,
                             num_microbatches=m, flash_attn=flash, schedule=schedule)
        # the parameters depend on the model and pp alone: one init a model,
        # the JAX pipeline's own under one jit
        if model not in inits:
            inits[model] = jax.device_get(jax.jit(lambda: plm.init(seed=0)[0])())
        params = inits[model]
        batches = np.stack(list(synthetic_lm_batches(
            batch_size=worker.BATCH, seq_len=worker.SEQ, vocab=MODEL_CONFIGS[model].vocab,
            num_batches=3, seed=1)))
        data.update(_flat(params, f"{case}:p0"))
        data[f"{case}:tokens"] = batches
        jax_runs[case] = (plm, params, batches)
    np.savez(tmp_path / "data.npz", **data)
    ctx = mp.start_processes(worker.run, nprocs=WORLD, join=False, start_method="spawn",
                             args=(WORLD, str(tmp_path / "store"), str(tmp_path / "data.npz"),
                                   str(tmp_path)))
    try:
        with ThreadPoolExecutor(len(jax_runs)) as pool:
            runs = {case: pool.submit(_jax_run, *args) for case, args in jax_runs.items()}
            results = {case: f.result(timeout=TIMEOUT_S) for case, f in runs.items()}
    finally:
        _wait(ctx, deadline)

    found = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(WORLD)]
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(WORLD)]
    for case, (model, dp, m, flash, schedule) in worker.CASES.items():
        losses, grads = results[case]
        cfg = MODEL_CONFIGS[model]
        held = [(f, a) for f, a in zip(found, ranks) if case in f]
        assert sorted(tuple(f[case]["coords"]) for f, _ in held) == sorted(
            (s, c) for s in range(2) for c in range(dp))
        for f, arrays in held:
            stage = f[case]["coords"][0]
            assert f[case]["local_batch"] == [worker.BATCH // dp, worker.SEQ]
            np.testing.assert_allclose(f[case]["losses"], losses, rtol=LOSS_RTOL, err_msg=case)
            assert f[case]["grad_loss"] == pytest.approx(losses[0], rel=LOSS_RTOL)
            ref = params_from_jax(grads, cfg, stage=stage)
            top = max(float(np.linalg.norm(r.numpy())) for r in ref.values())
            for name, r in ref.items():
                r = r.numpy()
                # the key bias's exact gradient is 0 (softmax ignores a
                # constant added to a row's scores): held to the model's scale
                scale = top if name.endswith("attn.key.bias") else np.linalg.norm(r)
                err = float(np.linalg.norm(arrays[f"{case}:grad:{name}"] - r)) / scale
                assert err < (MOE_JAX_GRAD_RTOL if cfg.n_experts else JAX_GRAD_RTOL), (
                    case, stage, name, err)
            assert f[case]["sequential_grad_err"] < GRAD_RTOL, (case, f[case])
            assert f[case]["sequential_loss"] == pytest.approx(losses[0], rel=LOSS_RTOL)
    for f in found:
        assert f["remat_equal"] and f["remat_step_equal"]
        ck = f["ckpt"]
        assert ck["resumed"] == ck["straight"] and ck["count"] == 1
        assert ".metadata" in ck["files"]
        assert ck["dp4_loss"] == pytest.approx(ck["straight"][0], rel=2e-4)
        assert f["cli"]["rc"] == 0 and f["cli_restore"]["rc"] == 0
        assert f["profile_warnings"] == []
        assert f["profile_errors"] == ["pp=2 composes with dp only; got sp=2, tp=1",
                                       "ks [3] not divisible by sp*tp*pp=2"]
        assert "PipelinedLM" in f["sharded_pp_error"]
    lines = [f["cli"]["out"].strip() for f in found]
    assert sum(bool(line) for line in lines) == 1
    summary = json.loads(next(line for line in lines if line))
    assert summary["mesh"] == {"pp": 2, "dp": 2, "sp": 1, "tp": 1}
    assert np.isfinite(summary["last_loss"]) and summary["steps"] == 3
    resumed = json.loads(next(f["cli_restore"]["out"] for f in found
                              if f["cli_restore"]["out"].strip()))
    assert resumed["resumed_at_step"] == 3
    curves = json.loads((tmp_path / "curves.json").read_text())
    entry = curves["transformer-tiny@sp1tp1pp2"]
    assert "pp=2" in entry["source"] and "measured<= 4 chips" in entry["source"]
    assert {"2", "64"} <= set(entry["points"])
