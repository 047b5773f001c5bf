"""Port parity for the routed MoE family: ``MoeMlp``, the MoE LMs
(``moe-tiny``, ``moe-top2-tiny``), their train steps and their profile,
in ``gpuschedule_tpu_torch`` against the JAX package on the CPU.

Inputs come from a numpy seed; parameters are flax's, carried across with
``params_from_jax``.  The JAX side's dispatch and combine tensors are read
by wrapping ``jnp.einsum`` while the flax module is traced, and returned
from the jitted function; nothing in the JAX package changes.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from gpuschedule_tpu.models import build_model as jax_build_model  # noqa: E402
from gpuschedule_tpu.models.config import MODEL_CONFIGS as JAX_CONFIGS  # noqa: E402
from gpuschedule_tpu.models.transformer import MoeMlp as JaxMoeMlp  # noqa: E402
from gpuschedule_tpu.ops import flash_attention as jax_flash  # noqa: E402, F401
from gpuschedule_tpu.parallel import ShardedTrainer as JaxTrainer  # noqa: E402
from gpuschedule_tpu.parallel import make_mesh  # noqa: E402
from gpuschedule_tpu.profiler import goodput as jax_goodput  # noqa: E402
from gpuschedule_tpu.profiler import harness as jax_harness  # noqa: E402
from gpuschedule_tpu_torch.convert import params_from_jax  # noqa: E402
from gpuschedule_tpu_torch.data import synthetic_lm_batches  # noqa: E402
from gpuschedule_tpu_torch.models import MODEL_CONFIGS, build_model  # noqa: E402
from gpuschedule_tpu_torch.models.transformer import MoeMlp  # noqa: E402
from gpuschedule_tpu_torch.parallel import ShardedTrainer  # noqa: E402
from gpuschedule_tpu_torch.profiler import CurveCache, profile_model  # noqa: E402

# one bf16 ulp at the outputs' scale (|y| < 0.5 at module level: 2^-9 ulp)
MODULE_ATOL = 2 ** -8
AUX_RTOL = 1e-5
ROUTE_GAP = 1e-4  # a route may differ only where the top-k logits nearly tie
# relative L2 distance of one step's parameter update from the JAX
# trainer's: adam's first updates are ±lr an entry, so an entry whose
# gradient is bf16 noise takes either sign, and an expert that a token
# reaches in one package and not the other updates differently (0.44 seen,
# on an expert bias; a gradient path left out moves a leaf by more than 1)
UPDATE_RTOL = 0.6
# relative L2 distance of a step-1 MoE gradient from jax.grad's on the same
# parameters and batch: 1-3.6% seen (bf16 activations rounded at other
# points, as the dense LM's 2.6%); a gradient at the wrong scale, or a term
# left out, is further off
MOE_GRAD_RTOL = 0.1
# the same at module level, routes equal (relative L2): the output term's
# gradients 0.25-0.7% off (bf16 einsums), the aux's 3e-5 at most
MOE_MODULE_GRAD_RTOL = {"out": 2e-2, "aux": 1e-3}


def _flat_params(tree, prefix=""):
    """{"router.kernel": leaf, "w_up": leaf, ...} of a flax parameter tree."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat_params(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


def _jax_moe(cfg, x, params=None, seed=1):
    """flax ``MoeMlp`` on numpy ``x``: (params, y, aux, dispatch, combine),
    dispatch and combine read from the einsums' arguments while tracing."""
    layer = JaxMoeMlp(cfg)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    if params is None:
        # the parameters only: an init's sown aux would come first in the
        # moe_losses of every apply on these variables
        params = {"params": jax.device_get(
            jax.jit(layer.init)(jax.random.PRNGKey(seed), xb)["params"])}
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
        return y, mods, seen["td,tec->ecd"], seen["ecd,tec->td"]

    y, mods, dispatch, combine = jax.device_get(jax.jit(run)(params, xb))
    aux = float(jax.tree_util.tree_leaves(mods["moe_losses"])[0])
    return params, np.asarray(y, np.float32), aux, dispatch, combine


def _port_layer(cfg, params):
    """The port's ``MoeMlp`` holding flax ``MoeMlp`` parameters."""
    layer = MoeMlp(cfg)
    p = params["params"]
    layer.load_state_dict({
        "router.kernel": torch.tensor(np.asarray(p["router"]["kernel"])),
        "router.bias": torch.tensor(np.asarray(p["router"]["bias"])),
        **{k: torch.tensor(np.asarray(p[k])) for k in ("w_up", "b_up", "w_down", "b_down")},
    })
    return layer


def _port_moe(cfg, params, x):
    """The port's ``MoeMlp`` on the same parameters: (y, aux, dispatch, combine)."""
    layer = _port_layer(cfg, params)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        y, aux = layer(xt)
        dispatch, combine, _ = layer.route(xt)
    return y.float().numpy(), float(aux), dispatch.float().numpy(), combine.float().numpy()


def _cfg(name, **kw):
    return dataclasses.replace(MODEL_CONFIGS[name], **kw)


@pytest.mark.parametrize("name", ["moe-tiny", "moe-top2-tiny"])
def test_moe_mlp_matches_flax(name):
    """The dispatch slots equal flax's exactly; combine (bf16 gates) within
    one bf16 ulp of each gate; the output within one bf16 ulp at its scale;
    the aux (with the z-loss for top-2) within AUX_RTOL."""
    cfg = _cfg(name)
    x = np.random.default_rng(0).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    params, y_ref, aux_ref, d_ref, c_ref = _jax_moe(JAX_CONFIGS[name], x)
    y, aux, d, c = _port_moe(cfg, params, x)
    assert d.shape == d_ref.shape and d.any()
    np.testing.assert_array_equal(d, d_ref)
    np.testing.assert_allclose(c, c_ref, rtol=2 ** -8, atol=0)
    np.testing.assert_allclose(y, y_ref, atol=MODULE_ATOL, rtol=0)
    assert aux == pytest.approx(aux_ref, rel=AUX_RTOL)


@pytest.mark.parametrize("name,z", [("moe-tiny", 0.0), ("moe-top2-tiny", 0.1)],
                         ids=["top1", "top2-z"])
def test_moe_mlp_gradients_match_flax(name, z):
    """Backward through ``MoeMlp`` on flax's parameters and input, routes
    equal: each leaf's gradient and the input's, of ``sum(y·g)`` and of the
    aux alone (the z-loss on for top-2), within MOE_MODULE_GRAD_RTOL of
    ``jax.grad`` (relative L2).  The aux's gradient reaches only the router
    and the input, in both packages."""
    cfg = _cfg(name, router_z_weight=z)
    jcfg = dataclasses.replace(JAX_CONFIGS[name], router_z_weight=z)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    params, *_ = _jax_moe(jcfg, x)
    layer = JaxMoeMlp(jcfg)

    def terms(params, xb):
        y, mods = layer.apply(params, xb, mutable=["moe_losses"])
        aux = jax.tree_util.tree_leaves(mods["moe_losses"])[0]
        return jnp.sum(y.astype(jnp.float32) * g), aux

    grads = jax.jit(lambda p, xb: tuple(
        jax.grad(lambda p, xb: terms(p, xb)[i], argnums=(0, 1))(p, xb) for i in (0, 1)))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    refs = jax.device_get(grads(params, xb))

    ours = _port_layer(cfg, params)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    y, aux = ours(xt)
    names = [n for n, _ in ours.named_parameters()]
    leaves = [p for _, p in ours.named_parameters()] + [xt]
    for term, loss, (p_ref, x_ref) in zip(
            ("out", "aux"), ((y.float() * torch.from_numpy(g)).sum(), aux), refs):
        got = torch.autograd.grad(loss, leaves, retain_graph=True, allow_unused=True)
        ref = {**{n: torch.tensor(np.asarray(v))
                  for n, v in _flat_params(p_ref["params"]).items()},
               "x": torch.tensor(np.asarray(x_ref.astype(jnp.float32)))}
        for n, gr in zip(names + ["x"], got):
            if not ref[n].any():
                assert gr is None or not gr.any(), (term, n)
                continue
            rel = float((gr.float() - ref[n]).norm() / ref[n].norm())
            assert rel < MOE_MODULE_GRAD_RTOL[term], (term, n, rel)


def test_aux_and_z_loss_match_flax():
    """The load-balancing term alone, and with the router z-loss: each
    within AUX_RTOL of flax's, and the z-loss a positive live term."""
    x = np.random.default_rng(1).standard_normal((2, 16, 128)).astype(np.float32)
    auxes = {}
    for z in (0.0, 0.1):
        params, _, aux_ref, _, _ = _jax_moe(
            dataclasses.replace(JAX_CONFIGS["moe-top2-tiny"], router_z_weight=z), x)
        _, aux, _, _ = _port_moe(_cfg("moe-top2-tiny", router_z_weight=z), params, x)
        assert aux == pytest.approx(aux_ref, rel=AUX_RTOL)
        auxes[z] = aux
    assert auxes[0.1] > auxes[0.0] > 0.0


def test_capacity_overflow_drops_to_zero_not_nan():
    """capacity_factor 0.1: cap = 1 slot an expert for T = 32 tokens, so
    most tokens' outputs are exactly 0 (never NaN), as flax's are."""
    cfg = _cfg("moe-tiny", capacity_factor=0.1)
    x = np.random.default_rng(2).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    params, y_ref, _, d_ref, _ = _jax_moe(JAX_CONFIGS["moe-tiny"].__class__(
        **dataclasses.asdict(cfg)), x)
    y, _, d, _ = _port_moe(cfg, params, x)
    assert np.isfinite(y).all()
    assert (np.abs(y).max(axis=-1) == 0.0).sum() >= 16
    np.testing.assert_array_equal(d, d_ref)
    np.testing.assert_allclose(y, y_ref, atol=MODULE_ATOL, rtol=0)


def test_second_choices_queue_behind_first():
    """Top-2 at capacity_factor 1.0: second choices claim slots only after
    every first choice, so some drop; the slots equal flax's, and the
    output differs from the roomy run on the same parameters."""
    x = np.random.default_rng(3).standard_normal((2, 16, 128)).astype(np.float32)
    out = {}
    for cf in (1.0, 8.0):
        cfg = _cfg("moe-top2-tiny", capacity_factor=cf)
        jcfg = dataclasses.replace(JAX_CONFIGS["moe-top2-tiny"], capacity_factor=cf)
        params = None if cf == 1.0 else out[1.0][0]
        params, y_ref, _, d_ref, _ = _jax_moe(jcfg, x, params)
        y, _, d, _ = _port_moe(cfg, params, x)
        np.testing.assert_array_equal(d, d_ref)
        np.testing.assert_allclose(y, y_ref, atol=MODULE_ATOL, rtol=0)
        out[cf] = (params, y, d)
    tight, roomy = out[1.0], out[8.0]
    assert np.isfinite(tight[1]).all()
    # fewer routed choices kept under pressure, and the output moved
    assert tight[2].sum() < roomy[2].sum() == 2 * 32
    assert np.abs(tight[1] - roomy[1]).max() > 1e-3


def _route_flips(ours, ref, k):
    """[(layer, token, gap, drift)] where the top-k expert sets of two
    (T, E) router logits differ: gap is the reference's logit gap between
    its k-th and (k+1)-th experts, drift the largest difference between the
    two logit rows."""
    flips = []
    for layer, (a, b) in enumerate(zip(ours, ref)):
        top_a = np.sort(np.argsort(-a, axis=-1)[:, :k], axis=-1)
        top_b = np.sort(np.argsort(-b, axis=-1)[:, :k], axis=-1)
        for t in np.nonzero((top_a != top_b).any(axis=-1))[0]:
            srt = np.sort(b[t])[::-1]
            flips.append((layer, int(t), float(srt[k - 1] - srt[k]),
                          float(np.abs(a[t] - b[t]).max())))
    return flips


@pytest.fixture(scope="module")
def tokens():
    return next(synthetic_lm_batches(batch_size=2, seq_len=32, vocab=8192, num_batches=1))


@pytest.fixture(scope="module")
def flax_lm(tokens):
    """{name: (flax module, config, its "params" from flax's init)}."""
    out = {}
    for name in ("moe-tiny", "moe-top2-tiny"):
        jmodel, jcfg = jax_build_model(name)
        init = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(tokens))
        out[name] = (jmodel, jcfg, jax.device_get({"params": init["params"]}))
    return out


@pytest.mark.parametrize("name", ["moe-tiny", "moe-top2-tiny"])
def test_moe_lm_logits_and_loss_match_flax(name, tokens, flax_lm):
    """Whole MoE LMs on flax's parameters (the flax model jitted, as its
    trainer runs it).  Each block's routing, given flax's input to that
    block's MoE (its ``ln2`` output), puts every choice in flax's slot.
    End to end, bf16 rounding upstream moves the router logits by up to
    ~0.03, so a token near a tie may take other experts: each such token is
    reported with its logit gap, and fails where the gap is above ROUTE_GAP
    and above what the two rows' difference can cross.  Logits within 2
    bf16 ulps at the worst entry of every token routed alike and 1e-2 on
    average (the dense LM's bounds); the loss with the aux charged at the
    trainer's default weight within 5e-3, the trainer's bound."""
    jmodel, jcfg, params = flax_lm[name]
    jt = jnp.asarray(tokens)
    einsum = jnp.einsum

    def run(params, jt):
        dispatches = []

        def spy(spec, *ops, **kw):
            if spec == "td,tec->ecd":
                dispatches.append(ops[1].astype(jnp.float32))
            return einsum(spec, *ops, **kw)

        jnp.einsum = spy
        try:
            out = jmodel.apply(params, jt, capture_intermediates=True,
                               mutable=["intermediates", "moe_losses"])
        finally:
            jnp.einsum = einsum
        return out, dispatches

    (logits_ref, mods), dispatches_ref = jax.device_get(jax.jit(run)(params, jt))
    aux_ref = sum(float(a) for a in jax.tree_util.tree_leaves(mods["moe_losses"]))
    loss_ref = float(optax.softmax_cross_entropy_with_integer_labels(
        logits_ref[:, :-1], tokens[:, 1:]).mean()) + 1e-2 * aux_ref
    inter = [mods["intermediates"][f"block{i}"] for i in range(jcfg.n_layers)]

    model, cfg = build_model(name)
    model.load_state_dict(params_from_jax(params, cfg))
    for block, got, d_ref in zip(model.blocks, inter, dispatches_ref):
        x = torch.from_numpy(np.asarray(got["ln2"]["__call__"][0], np.float32)).to(torch.bfloat16)
        with torch.no_grad():
            dispatch, _, _ = block.moe.route(x)
        np.testing.assert_array_equal(dispatch.float().numpy(), d_ref)

    routers = []
    hooks = [b.moe.router.register_forward_hook(
        lambda mod, args, out: routers.append(out.reshape(-1, cfg.n_experts).numpy()))
        for b in model.blocks]
    tr = ShardedTrainer(name, batch_size=2, seq_len=32, device="cpu")
    batch = tr.to_device(tokens)
    with torch.no_grad():
        logits, aux = model.forward_with_aux(batch)
        loss = float(tr._loss(model, batch))
    for h in hooks:
        h.remove()
    routers_ref = [np.asarray(got["moe"]["router"]["__call__"][0]).reshape(-1, cfg.n_experts)
                   for got in inter]
    flips = _route_flips(routers[:cfg.n_layers], routers_ref, cfg.router_top_k)
    print(f"{name}: routes that differ (layer, token, gap, drift): {flips}")
    # a flip needs the two rows of logits to differ by half the gap at least
    assert all(gap <= max(ROUTE_GAP, 2 * drift) for _, _, gap, drift in flips), flips
    assert len(aux) == cfg.n_layers
    # a token routed elsewhere has other logits: the worst-entry bound
    # holds on the tokens routed alike in every layer, the mean on all
    err = np.abs(logits.numpy() - np.asarray(logits_ref)).reshape(-1, cfg.vocab)
    alike = np.ones(err.shape[0], bool)
    alike[[t for _, t, _, _ in flips]] = False
    assert err[alike].max() < 0.0625 and err.mean() < 1e-2, (err.max(), err.mean(), flips)
    # the router logits differ by bf16 rounding upstream, so the aux does
    # too (7e-4 relative seen); at module level it agrees to AUX_RTOL
    assert sum(float(a) for a in aux) == pytest.approx(aux_ref, rel=2e-3)
    assert loss == pytest.approx(loss_ref, abs=5e-3)


def _jax_loss_fn(trainer):
    """The JAX trainer's own ``loss_fn(params, batch)``: a closure of the
    function its jitted step wraps."""
    step_fn = trainer._step.__wrapped__
    return step_fn.__closure__[step_fn.__code__.co_freevars.index("loss_fn")].cell_contents


@pytest.mark.parametrize("name,flash", [("moe-tiny", False), ("moe-top2-tiny", True)],
                         ids=["top1-dense", "top2-flash"])
def test_moe_train_steps_match_jax(name, flash):
    """Three train steps on the same three batches, in lockstep: before
    each step the port's model takes the JAX trainer's current parameters
    (its adamw keeps its own moments).  On the first, the gradient of every
    MoE leaf (router, w_up, b_up, w_down, b_down; the aux charged) is
    within MOE_GRAD_RTOL of ``jax.grad`` of the JAX trainer's loss on the
    same parameters and batch.  Each step's loss (cross-entropy
    plus the charged aux) agrees with the JAX trainer's to 5e-3, the dense
    LM's bound, and each parameter's update is within UPDATE_RTOL of the
    JAX trainer's.  Free-running trajectories are not compared: a routing
    choice near a tie, or a token at the capacity edge, turns a parameter
    difference of one bf16 ulp into a different route or a drop, which
    moves a 64-token loss by ~1e-2 whatever the learning rate.  With flash
    the JAX side runs its Pallas kernels in interpret mode, the port its
    plain versions."""
    batches = list(synthetic_lm_batches(batch_size=2, seq_len=32, vocab=8192, num_batches=3))
    kw = dict(batch_size=2, seq_len=32, flash_attn=flash, learning_rate=3e-3)
    jt = JaxTrainer(name, make_mesh(dp=1, devices=jax.devices()[:1]), **kw)
    state = jt.init(seed=0)
    tr = ShardedTrainer(name, device="cpu", **kw)
    ts = tr.init(seed=0)
    with jt.mesh:
        grads_ref = jax.jit(jax.grad(_jax_loss_fn(jt)))(state[0], jnp.asarray(batches[0]))
    grads_ref = params_from_jax(jax.device_get(grads_ref), tr.cfg)
    for i, tokens in enumerate(batches):
        before = params_from_jax(jax.device_get(state[0]), tr.cfg)
        ts.model.load_state_dict(before)
        if i == 0:
            ts.model.zero_grad()
            tr._loss(ts.model, tr.to_device(tokens)).backward()
            moe = {n: p.grad for n, p in ts.model.named_parameters() if ".moe." in n}
            assert len(moe) == 6 * tr.cfg.n_layers
            rels = {n: float((g - grads_ref[n]).norm() / grads_ref[n].norm())
                    for n, g in moe.items()}
            print(f"{name}: step-1 MoE gradients, relative L2 to jax.grad: {rels}")
            assert max(rels.values()) < MOE_GRAD_RTOL, rels
        ts, loss = tr.step(ts, tr.to_device(tokens))
        state, ref = jt.step(state, jnp.asarray(tokens))
        after = params_from_jax(jax.device_get(state[0]), tr.cfg)
        assert math.isfinite(float(loss))
        assert abs(float(loss) - float(ref)) < 5e-3, (float(loss), float(ref))
        for pname, p in ts.model.named_parameters():
            if pname.endswith("attn.key.bias"):
                continue  # its exact gradient is 0: adam moves it on rounding noise
            ref_update = after[pname] - before[pname]
            rel = float((p.detach() - after[pname]).norm() / ref_update.norm())
            assert rel < UPDATE_RTOL, (pname, rel)


def test_cli_trains_an_moe_model(capsys):
    """``train`` runs an MoE LM (top-2, with the flash op's plain versions)
    and prints the JAX CLI's summary keys."""
    from gpuschedule_tpu_torch.cli import main

    rc = main(["train", "--model", "moe-top2-tiny", "--steps", "2", "--batch-size", "2",
               "--seq-len", "32", "--flash-attn", "--device", "cpu"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["model"] == "moe-top2-tiny" and line["steps"] == 2
    assert math.isfinite(line["first_loss"]) and math.isfinite(line["last_loss"])


def test_aux_weight_is_charged():
    """moe_aux_weight moves the loss on the same state and batch, as in
    the JAX trainer; 0 leaves the cross-entropy alone."""
    losses = {}
    for w in (0.0, 0.5):
        tr = ShardedTrainer("moe-tiny", batch_size=2, seq_len=16, moe_aux_weight=w, device="cpu")
        st = tr.init(seed=0)
        batch = tr.make_batch(seed=0)
        with torch.no_grad():
            losses[w] = float(tr._loss(st.model, batch))
            logits = st.model(batch)
        if w == 0.0:
            assert losses[w] == pytest.approx(float(tr.loss(logits, batch)), rel=1e-6)
    assert losses[0.5] > losses[0.0]


def test_profile_writes_the_jax_cache(tmp_path, monkeypatch):
    """``profile_model("moe-tiny")`` measured on the CPU writes the cache
    entry the JAX package writes for the same measured step, byte for
    byte (key, ``source``, points, multislice fields)."""
    ours_path, ref_path = tmp_path / "ours.json", tmp_path / "ref.json"
    curve = profile_model("moe-tiny", batch_size=2, seq_len=32, cache=CurveCache(ours_path),
                          device="cpu")
    entry = json.loads(ours_path.read_text())["moe-tiny"]
    step_s = entry["points"]["1"]
    assert step_s > 0 and all(math.isfinite(t) and t >= 0 for t in curve.theta)
    monkeypatch.setattr(jax_harness, "measure_step_time", lambda *a, **k: step_s)
    jax_harness.profile_model("moe-tiny", devices=jax.devices()[:1],
                              cache=jax_goodput.CurveCache(ref_path))
    assert ours_path.read_bytes() == ref_path.read_bytes()


def test_params_from_jax_names_a_missing_leaf(flax_lm):
    _, jcfg, params = flax_lm["moe-tiny"]
    pruned = {**params["params"], "block1": {**params["params"]["block1"]}}
    pruned["block1"]["moe"] = {k: v for k, v in pruned["block1"]["moe"].items() if k != "w_up"}
    with pytest.raises(KeyError, match="flax parameter block1/moe/w_up is missing"):
        params_from_jax(pruned, jcfg)


def _leaf_stats(tree):
    return {name: (float(np.std(v)), float(np.mean(v)), v.size) for name, v in tree.items()}


def test_reset_parameters_follows_flax_initialisers(flax_lm):
    """Per-leaf std and mean of the port's init against flax's: each
    kernel's std within 4 standard errors of the two estimates (2% on the
    expert kernels, whose E·d fan-in is checked against its value too: a
    fan-in of d would be 2x off at E = 4), zeros and ones exact."""
    _, jcfg, params = flax_lm["moe-tiny"]
    ref = _leaf_stats({k: v.numpy() for k, v in params_from_jax(params, jcfg).items()})
    model, _ = build_model("moe-tiny")
    model.reset_parameters(torch.Generator().manual_seed(0))
    ours = _leaf_stats({k: v.detach().numpy() for k, v in model.state_dict().items()})
    assert ours.keys() == ref.keys()
    for name, (std, mean, size) in ours.items():
        ref_std, ref_mean, _ = ref[name]
        if ref_std == 0.0:
            assert (std, mean) == (0.0, ref_mean), name
        else:
            assert std == pytest.approx(ref_std, rel=4 / math.sqrt(size)), name
            assert abs(mean) < 4 * std / math.sqrt(size), name
    w_up = model.blocks[0].moe.w_up
    e, d, _ = w_up.shape
    assert float(w_up.detach().std()) == pytest.approx(1 / math.sqrt(e * d), rel=0.05)
