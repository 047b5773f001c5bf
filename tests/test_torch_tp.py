"""Tensor parallelism in one process, against the JAX package on the CPU:
the partition table, the shards of ``convert.py``, the vocab-parallel
loss, a tp model's initial shards, and the JAX MoE's routing on a
dp x tp mesh (which the port's ep-over-tp reproduces).

The collectives of two tp ranks run here on two threads of one process:
``torch.distributed.all_reduce`` is replaced, for the test, by a sum (or
max) across the threads behind a barrier.  The multi-process runs are in
``tests/test_torch_tp_dist.py``.
"""

import threading
from functools import partial

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from gpuschedule_tpu.models import build_model as jax_build_model  # noqa: E402
from gpuschedule_tpu.models.config import MODEL_CONFIGS as JAX_CONFIGS  # noqa: E402
from gpuschedule_tpu.models.transformer import MoeMlp as JaxMoeMlp  # noqa: E402
from gpuschedule_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from gpuschedule_tpu.parallel.train import param_partition_spec as jax_spec  # noqa: E402
from gpuschedule_tpu_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from gpuschedule_tpu_torch.models import MODEL_CONFIGS, CnnConfig, build_model  # noqa: E402
from gpuschedule_tpu_torch.parallel import tp as tp_mod  # noqa: E402
from gpuschedule_tpu_torch.parallel.tp import Tp, param_partition_spec  # noqa: E402
from gpuschedule_tpu_torch.parallel.train import make_optimizer  # noqa: E402

LM_NAMES = sorted(n for n, c in MODEL_CONFIGS.items() if not isinstance(c, CnnConfig))
CNN_NAMES = sorted(n for n, c in MODEL_CONFIGS.items() if isinstance(c, CnnConfig))


def _port_name(path) -> str:
    """The port's state_dict name of a flax path (``block0`` -> ``blocks.0``)."""
    keys = [getattr(k, "key", str(k)) for k in path]
    if keys[0] == "params":
        keys = keys[1:]
    if keys[0].startswith("block") and keys[0][5:].isdigit():
        keys = ["blocks", keys[0][5:]] + keys[1:]
    return ".".join(keys)


def _jax_dims(name: str) -> dict:
    """{port name: the dim JAX's ``param_partition_spec`` splits over tp,
    or None} for every parameter of zoo model ``name`` (shapes only)."""
    model, _ = jax_build_model(name)
    cnn = isinstance(MODEL_CONFIGS[name], CnnConfig)
    size = getattr(MODEL_CONFIGS[name], "image_size", 0)
    example = jnp.zeros((1, size, size, 3), jnp.float32) if cnn else jnp.zeros((1, 8), jnp.int32)
    # a CNN's "SAME" padding needs concrete shapes: its (small) init runs
    init = jax.jit(model.init) if cnn else partial(jax.eval_shape, model.init)
    shapes = init(jax.random.PRNGKey(0), example)["params"]
    out = {}

    def visit(path, leaf):
        spec = tuple(jax_spec(path, leaf))
        out[_port_name(path)] = spec.index("tp") if "tp" in spec else None

    jax.tree_util.tree_map_with_path(visit, shapes)
    return out


@pytest.mark.parametrize("name", LM_NAMES + ["resnet-tiny"])
def test_partition_table_matches_jax(name):
    """Parameter by parameter, the port's table splits the dim that the
    JAX rule splits (or none), and a tp = 2 model built on the meta device
    holds each split parameter at half its whole shape along that dim,
    every other at its whole shape.  A CNN has no split parameter."""
    ref = _jax_dims(name)
    with torch.device("meta"):
        whole, _ = build_model(name)
        split, _ = build_model(name, tp=Tp(2, 1))
    shapes = {n: p.shape for n, p in whole.named_parameters()}
    assert set(shapes) == set(ref)
    for n, shape in shapes.items():
        dim = param_partition_spec(n, len(shape))
        assert dim == ref[n], (n, dim, ref[n])
        want = list(shape)
        if dim is not None:
            want[dim] //= 2
        assert list(dict(split.named_parameters())[n].shape) == want, n
    if name in CNN_NAMES:
        assert all(d is None for d in ref.values())
    else:
        assert {d for d in ref.values()} >= {0, 1}


@pytest.fixture(scope="module")
def flax_params():
    """{name: (port config, flax params, an adamw opt_state)} for a dense
    and an MoE tiny model: the trees' structure from JAX (no compile),
    numpy normals for their values."""
    import optax

    rng = np.random.default_rng(0)
    fill = partial(jax.tree_util.tree_map,
                   lambda a: rng.standard_normal(a.shape).astype(np.float32))
    out = {}
    for name in ("transformer-tiny", "moe-tiny"):
        model, _ = jax_build_model(name)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        params = fill({"params": shapes["params"]})
        opt = fill(jax.eval_shape(optax.adamw(1e-3).init, params))
        out[name] = (MODEL_CONFIGS[name], params, opt)
    return out


@pytest.mark.parametrize("name", ["transformer-tiny", "moe-tiny"])
def test_shards_round_trip_through_convert(name, flax_params):
    """``params_from_jax`` and ``opt_state_from_jax`` with a rank's ``Tp``
    give that rank's shards: the two ranks' shards put back together along
    the table's dim are the whole tensors (replicated ones equal on both),
    and each rank's shards load into its tp = 2 model."""
    cfg, params, opt = flax_params[name]
    whole = params_from_jax(params, cfg)
    whole_opt = opt_state_from_jax(opt, cfg)
    shards = [params_from_jax(params, cfg, Tp(2, r)) for r in range(2)]
    opt_shards = [opt_state_from_jax(opt, cfg, Tp(2, r)) for r in range(2)]
    for n, t in whole.items():
        dim = param_partition_spec(n, t.dim())
        if dim is None:
            assert all(torch.equal(s[n], t) for s in shards), n
        else:
            assert torch.equal(torch.cat([s[n] for s in shards], dim), t), n
        for key in ("exp_avg", "exp_avg_sq"):
            k = f"optimizer.{n}.{key}"
            got = (opt_shards[0][k] if dim is None
                   else torch.cat([s[k] for s in opt_shards], dim))
            assert torch.equal(got, whole_opt[k]), k
    for r in range(2):
        model, _ = build_model(name, tp=Tp(2, r))
        model.load_state_dict(shards[r])


@pytest.mark.parametrize("name", ["transformer-tiny", "moe-top2-tiny"])
def test_tp_init_is_the_one_rank_init_sliced(name):
    """From one seed, each tp rank's parameters are its slices of the
    parameters a one-rank model draws (the card's phase 15 relies on it)."""
    one, _ = build_model(name)
    one.reset_parameters(torch.Generator().manual_seed(3))
    for r in range(2):
        model, _ = build_model(name, tp=Tp(2, r))
        model.reset_parameters(torch.Generator().manual_seed(3))
        for n, p in model.named_parameters():
            ref = dict(one.named_parameters())[n]
            dim = param_partition_spec(n, p.dim())
            assert torch.equal(p, Tp(2, r).shard(ref, dim)), n


class _Threads:
    """``dist.all_reduce`` across the threads of one test, each a rank:
    each thread's tensor is combined with the others' behind a barrier."""

    def __init__(self, n):
        self.barrier, self.slots, self.me = threading.Barrier(n), [None] * n, threading.local()

    def all_reduce(self, t, op=None, group=None):
        self.slots[self.me.rank] = t.clone()
        self.barrier.wait()
        vals = torch.stack(self.slots)
        out = vals.amax(0) if op == torch.distributed.ReduceOp.MAX else vals.sum(0)
        self.barrier.wait()  # every rank has read the slots
        t.copy_(out)


def _on_threads(monkeypatch, n, fn):
    """[fn(rank) for each of ``n`` ranks], run on ``n`` threads whose
    all-reduces meet."""
    fake = _Threads(n)
    monkeypatch.setattr(torch.distributed, "all_reduce", fake.all_reduce)
    out, errors = [None] * n, []

    def run(r):
        fake.me.rank = r
        try:
            out[r] = fn(r)
        except Exception as e:  # noqa: BLE001  (re-raised below)
            errors.append(e)
            fake.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return out


def test_vocab_parallel_loss_matches_cross_entropy(monkeypatch):
    """Two tp ranks' vocab slices of f32 logits (some labels in each
    slice): every rank's loss is ``F.cross_entropy``'s sum on the whole
    logits, and the ranks' logit gradients put together are its gradient."""
    gen = torch.Generator().manual_seed(0)
    n, v = 24, 64
    logits = torch.randn(n, v, generator=gen) * 4
    labels = torch.randint(0, v, (n,), generator=gen)
    logits_ref = logits.clone().requires_grad_(True)
    ref = F.cross_entropy(logits_ref, labels, reduction="sum")
    ref.backward()

    def rank(r):
        mine = logits[:, r * v // 2:(r + 1) * v // 2].clone().requires_grad_(True)
        loss = tp_mod.vocab_parallel_loss(mine, labels, Tp(2, r, group="tp"))
        loss.backward()
        return loss.detach(), mine.grad

    results = _on_threads(monkeypatch, 2, rank)
    for loss, _ in results:
        torch.testing.assert_close(loss, ref.detach(), rtol=1e-6, atol=1e-5)
    grad = torch.cat([g for _, g in results], dim=1)
    torch.testing.assert_close(grad, logits_ref.grad, rtol=1e-5, atol=1e-6)


def _jax_dispatch(cfg, params, x, mesh=None):
    """The flax ``MoeMlp``'s dispatch on ``x`` (read from its dispatch
    einsum while tracing), with ``x`` on ``mesh`` split over dp and the
    expert weights over tp when a mesh is given."""
    layer = JaxMoeMlp(cfg)
    einsum = jnp.einsum

    def run(params, x):
        seen = {}

        def spy(spec, *ops, **kw):
            if spec == "td,tec->ecd":
                seen["d"] = ops[1].astype(jnp.float32)
            return einsum(spec, *ops, **kw)

        jnp.einsum = spy
        try:
            layer.apply(params, x, mutable=["moe_losses"])
        finally:
            jnp.einsum = einsum
        return seen["d"]

    xb = jnp.asarray(x).astype(jnp.bfloat16)
    if mesh is not None:
        xb = jax.device_put(xb, NamedSharding(mesh, P("dp", None, None)))
        params = jax.tree_util.tree_map_with_path(
            lambda path, v: jax.device_put(v, NamedSharding(
                mesh, P("tp") if getattr(path[-1], "key", "")[:2] in ("w_", "b_") else P())),
            params)
        with mesh:
            return np.asarray(jax.jit(run)(params, xb))
    return np.asarray(jax.jit(run)(params, xb))


def test_jax_moe_routes_the_global_batch_on_a_dp_tp_mesh():
    """The routing the port's ep-over-tp reproduces: the flax ``MoeMlp``
    with its input split over dp = 2 and its experts over tp = 2 (the
    trainer's shardings) puts every choice in the slot it takes unsharded
    (capacity and slot scan over the global batch, GSPMD), which is not
    the slot that routing each dp half alone gives."""
    cfg = JAX_CONFIGS["moe-top2-tiny"]
    x = np.random.default_rng(0).standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    layer = JaxMoeMlp(cfg)
    params = jax.device_get(jax.jit(layer.init)(
        jax.random.PRNGKey(1), jnp.asarray(x).astype(jnp.bfloat16)))
    params = {"params": params["params"]}
    whole = _jax_dispatch(cfg, params, x)
    mesh = jax_make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    np.testing.assert_array_equal(_jax_dispatch(cfg, params, x, mesh), whole)
    halves = [_jax_dispatch(cfg, params, x[i:i + 2]) for i in (0, 2)]
    assert any(h.shape != whole[:32].shape or not np.array_equal(h, whole[i * 32:(i + 1) * 32])
               for i, h in enumerate(halves))


def test_moe_routes_over_two_dp_ranks_equal_one_rank(monkeypatch):
    """The port's ``MoeMlp`` over two dp ranks (a ``TokenLayout`` each, the
    counts exchanged by the threads' all-reduce), top-2 with a tight
    capacity: each rank's dispatch and combine are the one-rank module's
    rows for its tokens, and the ranks' aux shares sum to its aux."""
    import dataclasses

    from gpuschedule_tpu_torch.models.transformer import MoeMlp
    from gpuschedule_tpu_torch.parallel.tp import TokenLayout

    cfg = dataclasses.replace(MODEL_CONFIGS["moe-top2-tiny"], capacity_factor=1.0)
    one = MoeMlp(cfg)
    one.router.reset_parameters(torch.Generator().manual_seed(0))
    one.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.randn(4, 16, cfg.d_model, generator=torch.Generator().manual_seed(2)).to(
        torch.bfloat16)
    with torch.no_grad():
        d_ref, c_ref, aux_ref = one.route(x)

    def rank(r):
        layer = MoeMlp(cfg)
        layer.load_state_dict(one.state_dict())
        layer.tokens = TokenLayout(batch=4, row0=2 * r, chunk=0, chunks=1, writes=True,
                                   replicas=1, group="dp")
        with torch.no_grad():
            return layer.route(x[2 * r:2 * r + 2])

    results = _on_threads(monkeypatch, 2, rank)
    assert d_ref.sum() < 2 * 64  # some second choices drop at capacity 1.0
    for r, (d, c, _) in enumerate(results):
        assert torch.equal(d, d_ref[32 * r:32 * (r + 1)])
        assert torch.equal(c, c_ref[32 * r:32 * (r + 1)])
    torch.testing.assert_close(sum(a for _, _, a in results), aux_ref, rtol=1e-6, atol=0)


def test_clip_norm_over_tp_is_the_whole_models(monkeypatch):
    """The global-norm clip over two tp ranks: the split parameters'
    squares summed over tp, the replicated counted once, gives the
    one-rank norm of the whole gradients, and the same scale."""
    from gpuschedule_tpu_torch.parallel.train import clip_by_global_norm

    model, _ = build_model("transformer-tiny")
    gen = torch.Generator().manual_seed(5)
    grads = {n: torch.randn(p.shape, generator=gen) for n, p in model.named_parameters()}
    params = [torch.nn.Parameter(torch.zeros_like(g)) for g in grads.values()]
    for p, g in zip(params, grads.values()):
        p.grad = g.clone()
    ref = clip_by_global_norm(params, 1.0)

    def rank(r):
        tp = Tp(2, r, group="tp")
        mine, sharded = [], []
        for n, g in grads.items():
            dim = param_partition_spec(n, g.dim())
            p = torch.nn.Parameter(torch.zeros_like(tp.shard(g, dim)))
            p.grad = tp.shard(g, dim).clone()
            mine.append(p)
            if dim is not None:
                sharded.append(p)
        opt = make_optimizer(mine, 1e-3, grad_clip=1.0, tp=tp, sharded=sharded)
        norm = clip_by_global_norm(mine, 1.0, opt.tp, opt.sharded)
        return norm, {n: p.grad for n, p in zip(grads, mine)}

    results = _on_threads(monkeypatch, 2, rank)
    for norm, _ in results:
        torch.testing.assert_close(norm, ref, rtol=1e-5, atol=0)
    for n, p in zip(grads, params):
        dim = param_partition_spec(n, p.dim())
        whole = (results[0][1][n] if dim is None
                 else torch.cat([res[1][n] for res in results], dim))
        torch.testing.assert_close(whole, p.grad, rtol=1e-5, atol=1e-8)
