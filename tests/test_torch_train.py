"""Port parity for the model, the train step and its entry points: ``transformer-tiny`` in
``gpuschedule_tpu_torch`` against the JAX package on the CPU.

Parameters are initialised by JAX and carried across with
``params_from_jax``; tokens come from the numpy ``synthetic_lm_batches``
stream, whose two copies draw the same tokens.  The JAX flash path runs
its Pallas kernels in interpret mode, as its own tests do.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from gpuschedule_tpu.data import synthetic_lm_batches as jax_batches  # noqa: E402
from gpuschedule_tpu.models import build_model as jax_build_model  # noqa: E402
from gpuschedule_tpu.models.config import MODEL_CONFIGS as JAX_CONFIGS  # noqa: E402
from gpuschedule_tpu.ops import flash_attention as jax_flash  # noqa: E402
from gpuschedule_tpu.parallel import ShardedTrainer as JaxTrainer  # noqa: E402
from gpuschedule_tpu.parallel import make_mesh  # noqa: E402
from gpuschedule_tpu_torch.cli import main  # noqa: E402
from gpuschedule_tpu_torch.convert import params_from_jax  # noqa: E402
from gpuschedule_tpu_torch.data import synthetic_lm_batches  # noqa: E402
from gpuschedule_tpu_torch.models import MODEL_CONFIGS, build_model  # noqa: E402
from gpuschedule_tpu_torch.ops import flash_attention  # noqa: E402
from gpuschedule_tpu_torch.parallel import ShardedTrainer  # noqa: E402
from gpuschedule_tpu_torch.parallel.train import lr_factor  # noqa: E402
from gpuschedule_tpu_torch.profiler import measure_step_time, time_callable  # noqa: E402

MODEL = "transformer-tiny"


def test_config_copy_matches_jax_zoo():
    assert sorted(MODEL_CONFIGS) == sorted(JAX_CONFIGS)
    for name, cfg in MODEL_CONFIGS.items():
        ref = JAX_CONFIGS[name]
        assert type(cfg).__name__ == type(ref).__name__
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.param_count == ref.param_count
        assert cfg.flops_per_token() == ref.flops_per_token()
        assert getattr(cfg, "active_param_count", None) == getattr(ref, "active_param_count", None)


def test_token_stream_copy_matches_jax():
    kw = dict(batch_size=2, seq_len=16, vocab=100, num_batches=5, seed=3,
              start=1, host_shard=(1, 2))
    ours, ref = list(synthetic_lm_batches(**kw)), list(jax_batches(**kw))
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_tiny():
    """transformer-tiny params from flax's init (the function the JAX
    trainer's ``init`` jits), and one token batch."""
    tokens = next(synthetic_lm_batches(batch_size=2, seq_len=64, vocab=8192, num_batches=1))
    model, cfg = jax_build_model(MODEL)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(tokens))
    return cfg, jax.device_get({"params": params["params"]}), tokens


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_logits_match_jax(jax_tiny, flash):
    """bf16 compute on both sides with the roundings at the same points
    (module docstring of models/transformer.py); what differs is the order
    of f32 sums inside a product, which moves a bf16 result by an ulp.
    Logits reach ~5, where a bf16 ulp is 2^-5: held to 0.0625 (2 ulps) at
    the worst entry and 1e-2 on average."""
    cfg, params, tokens = jax_tiny
    jfn = (lambda q, k, v: jax_flash(q, k, v, causal=True)) if flash else None
    jmodel, _ = jax_build_model(MODEL, attn_fn=jfn)
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(tokens)))

    tfn = (lambda q, k, v: flash_attention(q, k, v, causal=True)) if flash else None
    model, _ = build_model(MODEL, attn_fn=tfn)
    model.load_state_dict(params_from_jax(params, cfg))
    with torch.no_grad():
        out = model(torch.from_numpy(tokens).long())
    assert out.dtype == torch.float32 and out.shape == ref.shape
    err = np.abs(out.numpy() - ref)
    assert err.max() < 0.0625 and err.mean() < 1e-2, (err.max(), err.mean())


@pytest.mark.parametrize(
    "opt", [{}, dict(warmup_steps=1, decay_steps=3, grad_clip=0.5)],
    ids=["adamw", "warmup-decay-clip"],
)
def test_flash_train_steps_match_jax(jax_tiny, opt):
    """Three flash-attention train steps from the same transferred init on
    the same three batches: the losses agree to 5e-3 (observed ~1.5e-3 on
    losses near 9.6, the bf16 logit differences above averaged over the
    batch).  The second run's warmup makes its first update zero and its
    clip and cosine change the second and third losses by ~0.17, so a
    schedule or clip off by one step would show."""
    batches = list(synthetic_lm_batches(batch_size=2, seq_len=64, vocab=8192, num_batches=3))
    kw = dict(batch_size=2, seq_len=64, flash_attn=True, learning_rate=3e-3, **opt)

    _, params, _ = jax_tiny
    jt = JaxTrainer(MODEL, make_mesh(dp=1, devices=jax.devices()[:1]), **kw)
    # the trainer's own state, its params replaced by the fixture's (adam's
    # moments start at zero either way); placed like the trainer places them
    init_params, opt_state = jt.init(seed=0)
    state = (jax.tree.map(lambda a, r: jax.device_put(a, r.sharding), params, init_params),
             opt_state)
    ref = []
    for tokens in batches:
        state, loss = jt.step(state, jnp.asarray(tokens))
        ref.append(float(loss))

    tr = ShardedTrainer(MODEL, device="cpu", **kw)
    ts = tr.init(seed=0)
    ts.model.load_state_dict(params_from_jax(params, tr.cfg))
    ours = []
    for tokens in batches:
        ts, loss = tr.step(ts, tr.to_device(tokens))
        ours.append(float(loss))
    np.testing.assert_allclose(ours, ref, atol=5e-3, rtol=0)


def test_lr_schedule_matches_optax():
    lr = 1e-3
    cases = [
        (dict(warmup_steps=3, decay_steps=5),
         optax.warmup_cosine_decay_schedule(0.0, lr, 3, 3 + 5)),
        (dict(warmup_steps=0, decay_steps=4),
         optax.warmup_cosine_decay_schedule(0.0, lr, 0, 4)),
        (dict(warmup_steps=4), optax.warmup_constant_schedule(0.0, lr, 4)),
        (dict(), optax.constant_schedule(lr)),
    ]
    for kw, sched in cases:
        for count in range(12):
            assert lr * lr_factor(count, **kw) == pytest.approx(float(sched(count)), rel=1e-6, abs=1e-12), (kw, count)


def test_trainer_cpu_step_decreases_loss_on_one_batch():
    """The port's own trainer, port-side init: repeated steps on one batch
    lower the loss (the descent check of the JAX suite)."""
    tr = ShardedTrainer(MODEL, batch_size=1, seq_len=16, flash_attn=True, device="cpu")
    state = tr.init(seed=0)
    tokens = tr.make_batch(seed=0)
    losses = []
    for _ in range(3):
        state, loss = tr.step(state, tokens)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_cli_train_on_cpu(capsys):
    rc = main(["train", "--model", MODEL, "--steps", "2", "--batch-size", "2",
               "--seq-len", "32", "--flash-attn", "--device", "cpu",
               "--warmup-steps", "1", "--decay-steps", "2", "--grad-clip", "1.0"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["model"] == MODEL and line["steps"] == 2
    assert line["device"] == "cpu" and line["tokens_per_s"] > 0
    assert line["first_loss"] > 0 and line["last_loss"] > 0


def test_harness_on_cpu():
    s = measure_step_time(MODEL, batch_size=2, seq_len=16, warmup=1, iters=1, device="cpu")
    assert s > 0
    assert time_callable(torch.matmul, torch.ones(8, 8), torch.ones(8, 8), iters=2) > 0
