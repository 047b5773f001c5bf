"""The pipeline's pieces in one process on the CPU, against the JAX
``PipelinedLM`` on (pp, dp) meshes of the conftest's virtual CPU devices.
The ranks' schedule is held to it in ``tests/test_torch_pipeline_dist.py``.

- ``convert.py`` carries the JAX pipeline's parameters and adamw state to
  each stage's rank: the embedding and head whole, the stage's slice of
  each stacked block leaf; ``stack_stage_params`` stacks the stages back
  into the reference's layout, to the bit;
- ``reference_loss`` of the whole model holding those parameters equals
  the JAX ``reference_loss`` (dense and MoE), and with
  ``per_microbatch=True`` the JAX pipelined loss of the MoE at M = 2 and
  dp = 2, whose routes and aux are per (microbatch, dp column);
- the refusals of ``PipelinedLM`` are the reference's, word for word;
- ``BatchSharding`` with blocks gives a rank its rows of every microbatch;
  the dense core with a causal offset over the whole sequence's keys gives
  the rows of a chunk of the full attention.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gpuschedule_tpu.parallel import PipelinedLM as JaxPipelinedLM  # noqa: E402
from gpuschedule_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from gpuschedule_tpu_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from gpuschedule_tpu_torch.data import BatchSharding, synthetic_lm_batches  # noqa: E402
from gpuschedule_tpu_torch.models import MODEL_CONFIGS, build_model  # noqa: E402
from gpuschedule_tpu_torch.models.transformer import dense_self_attention  # noqa: E402
from gpuschedule_tpu_torch.parallel import Mesh, PipelinedLM, stack_stage_params  # noqa: E402
from gpuschedule_tpu_torch.parallel.pipeline import whole_names  # noqa: E402

LOSS_RTOL = 5e-3
BATCH, SEQ = 8, 32


def _mesh(pp, dp=1, sp=1, tp=1):
    """A port mesh of that shape on the CPU, without process groups: what a
    constructor's checks see before any collective."""
    return Mesh({"pp": pp, "dp": dp, "sp": sp, "tp": tp}, torch.device("cpu"))


def _jax(model, dp, m):
    mesh = jax_make_mesh(pp=2, dp=dp, devices=jax.devices()[:2 * dp])
    plm = JaxPipelinedLM(model, mesh, batch_size=BATCH, seq_len=SEQ, num_microbatches=m)
    params, opt_state = jax.jit(lambda: plm.init(seed=0))()
    return plm, jax.device_get(params), jax.device_get(opt_state)


def _whole(params, cfg, pp=2):
    """The whole one-rank model holding every stage's parameters."""
    model, _ = build_model(cfg.name)
    sd = {}
    for stage in range(pp):
        sd.update(whole_names(params_from_jax(params, cfg, stage=stage),
                              stage * cfg.n_layers // pp))
    model.load_state_dict(sd)
    return model


def _tokens(cfg, seed=3):
    return next(synthetic_lm_batches(batch_size=BATCH, seq_len=SEQ, vocab=cfg.vocab,
                                     num_batches=1, seed=seed))


@pytest.fixture(scope="module")
def moe_top2():
    return _jax("moe-top2-tiny", 2, 2)


def test_convert_carries_each_stage_and_stacks_back(moe_top2):
    plm, params, opt_state = moe_top2
    cfg = MODEL_CONFIGS["moe-top2-tiny"]
    stages = [params_from_jax(params, cfg, stage=s) for s in range(2)]
    for sd in stages:
        assert sorted(sd) == sorted(k for k in build_model(cfg.name)[0].state_dict()
                                    if not k.startswith("blocks.1."))
        np.testing.assert_array_equal(sd["embed.embedding"],
                                      params["embed"]["params"]["embed"]["embedding"])
        np.testing.assert_array_equal(sd["lm_head.kernel"],
                                      params["head"]["params"]["lm_head"]["kernel"])
    stacked = stack_stage_params([{k: v for k, v in sd.items() if k.startswith("blocks.")}
                                  for sd in stages])
    router = params["stages"]["layer0"]["params"]["moe"]["router"]["kernel"]
    np.testing.assert_array_equal(stacked["blocks.0.moe.router.kernel"], router)
    assert stacked["blocks.0.moe.w_up"].shape == (2, 4, 128, 256)
    # adamw's moments after one step, each stage's slice under the rank's names
    _, opt_state = jax.device_get(plm.step((jax.device_put(params), jax.device_put(opt_state)),
                                           jnp.asarray(_tokens(cfg)))[0])
    opt = opt_state_from_jax(opt_state, cfg, stage=1)
    mu = opt_state[0].mu["stages"]["layer0"]["params"]["moe"]["w_down"][1]
    np.testing.assert_array_equal(opt["optimizer.blocks.0.moe.w_down.exp_avg"], mu)
    assert int(opt["optimizer.count"]) == 1
    named = whole_names(opt, 1)
    assert "optimizer.blocks.1.moe.w_down.exp_avg" in named
    assert "optimizer.embed.embedding.exp_avg" in named


@pytest.mark.parametrize("model", ["transformer-tiny", "moe-top2-tiny"])
def test_reference_loss_matches_jax(model, moe_top2):
    plm, params, _ = moe_top2 if model == "moe-top2-tiny" else _jax(model, 1, 4)
    cfg = MODEL_CONFIGS[model]
    tokens = _tokens(cfg)
    want = float(jax.jit(plm.reference_loss)(params, jnp.asarray(tokens)))
    port = PipelinedLM.__new__(PipelinedLM)  # the oracle reads the trainer's M, dp and weight
    port.rows, port.moe_aux_weight = BATCH // plm.num_microbatches // plm.mesh.shape["dp"], 1e-2
    with torch.no_grad():
        got = port.reference_loss(_whole(params, cfg), torch.from_numpy(tokens).long()).item()
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def test_per_microbatch_reference_is_the_jax_pipelined_moe_loss(moe_top2):
    """At M = 2 and dp = 2 the JAX pipelined MoE loss is not its sequential
    ``reference_loss`` (the routes and the aux are per share); the port's
    oracle with ``per_microbatch`` is it."""
    plm, params, _ = moe_top2
    cfg = MODEL_CONFIGS["moe-top2-tiny"]
    tokens = jnp.asarray(_tokens(cfg))
    with plm.mesh:
        piped = float(jax.jit(plm._loss_fn)(params, tokens))
    sequential = float(jax.jit(plm.reference_loss)(params, tokens))
    port = PipelinedLM.__new__(PipelinedLM)
    port.rows, port.moe_aux_weight = BATCH // 2 // 2, 1e-2
    model = _whole(params, cfg)
    t = torch.from_numpy(np.array(tokens)).long()
    with torch.no_grad():
        shares = port.reference_loss(model, t, per_microbatch=True).item()
        whole = port.reference_loss(model, t).item()
    assert shares == pytest.approx(piped, rel=LOSS_RTOL)
    assert whole == pytest.approx(sequential, rel=LOSS_RTOL)
    assert abs(piped - sequential) > 10 * abs(shares - piped)  # the two forms do differ


@pytest.mark.parametrize("kw, mesh, message", [
    (dict(), _mesh(1), "PipelinedLM needs a pp>=2 mesh, got pp=1"),
    (dict(), _mesh(3), "transformer-tiny has 2 layers, not divisible by pp=3"),
    (dict(batch_size=6), _mesh(2), "batch 6 not divisible by 4 microbatches"),
    (dict(schedule="1f1b"), _mesh(2), "schedule must be 'gpipe' or 'remat', got '1f1b'"),
    (dict(), _mesh(2, tp=2), "pipeline_apply supports (pp, dp) meshes only; got extra axes "
                             "{'tp': 2}"),
    (dict(batch_size=4), _mesh(2, dp=2), "microbatch size 1 not divisible by dp=2"),
])
def test_pipelined_lm_refusals_are_the_references(kw, mesh, message):
    kw = {"batch_size": BATCH, "seq_len": SEQ, **kw}
    with pytest.raises(ValueError) as port:
        PipelinedLM("transformer-tiny", mesh, **kw)
    assert str(port.value) == message
    jmesh = jax_make_mesh(**{k: v for k, v in mesh.shape.items() if v > 1 or k == "pp"},
                          devices=jax.devices()[:mesh.size])
    with pytest.raises(ValueError) as ref, jmesh:
        # the reference raises the mesh's errors when its step is traced
        plm = JaxPipelinedLM("transformer-tiny", jmesh, **kw)
        jax.eval_shape(plm._loss_fn, jax.eval_shape(lambda: plm.init(seed=0)[0]),
                       jax.ShapeDtypeStruct((plm.batch_size, SEQ), jnp.int32))
    assert str(ref.value) == message


def test_batch_sharding_blocks_take_a_ranks_rows_of_each_microbatch():
    batch = np.arange(8 * 5).reshape(8, 5)
    share = BatchSharding(torch.device("cpu"), row0=1, rows=1, seq0=0, seq_len=4, blocks=4)
    np.testing.assert_array_equal(share.host_share(batch), batch[[1, 3, 5, 7]])
    whole = BatchSharding(torch.device("cpu"), row0=0, rows=8, seq0=0, seq_len=4)
    np.testing.assert_array_equal(whole.host_share(batch), batch)


def test_dense_core_with_a_causal_offset_is_a_chunk_of_the_full_attention():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 16, 2, 8), generator=gen).to(torch.bfloat16) for _ in range(3))
    full = dense_self_attention(q, k, v)
    for r in range(2):
        chunk = dense_self_attention(q[:, 8 * r:8 * (r + 1)], k, v, q_offset=8 * r)
        torch.testing.assert_close(chunk, full[:, 8 * r:8 * (r + 1)], rtol=0, atol=0)
