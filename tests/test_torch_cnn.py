"""Port parity for the CNN family: ``Conv``, ``GroupNorm``, ``ResBlock`` and
``ResNet`` (``resnet-tiny``, ``resnet-mid``), the image train step, the
profile and the ``train`` CLI's refusal, in ``gpuschedule_tpu_torch``
against the JAX package on the CPU.

Images and labels come from a numpy seed; parameters are flax's, carried
across with ``params_from_jax`` (a block's by flax path, with the same
mapping).  The stride-2 block is where flax's ``padding="SAME"`` pads
low 0, high 1: PyTorch's symmetric ``padding=1`` shifts every output
there, which its test sees.
"""

import contextlib
import io
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gpuschedule_tpu import cli as jax_cli  # noqa: E402
from gpuschedule_tpu.models import build_model as jax_build_model  # noqa: E402
from gpuschedule_tpu.models.cnn import ResBlock as JaxResBlock  # noqa: E402
from gpuschedule_tpu.parallel import ShardedTrainer as JaxTrainer  # noqa: E402
from gpuschedule_tpu.parallel import make_mesh  # noqa: E402
from gpuschedule_tpu.profiler import goodput as jax_goodput  # noqa: E402
from gpuschedule_tpu.profiler import harness as jax_harness  # noqa: E402
from gpuschedule_tpu_torch.cli import main  # noqa: E402
from gpuschedule_tpu_torch.convert import params_from_jax  # noqa: E402
from gpuschedule_tpu_torch.models import build_model  # noqa: E402
from gpuschedule_tpu_torch.models.cnn import GroupNorm, ResBlock  # noqa: E402
from gpuschedule_tpu_torch.parallel import ShardedTrainer  # noqa: E402
from gpuschedule_tpu_torch.profiler import CurveCache, capture_trace, profile_model  # noqa: E402

BF16 = torch.bfloat16


def _flat(tree, prefix=()):
    """{"a.b.c": numpy leaf} of a nested dict."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + (key,)))
        else:
            out[".".join(prefix + (key,))] = torch.tensor(np.asarray(val))
    return out


def _ulps(got, ref):
    """|got - ref| in bf16 ulps of |ref| (at least the ulp of 1/64)."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2 ** -6))) - 7)
    return np.abs(got - ref) / ulp


@pytest.mark.parametrize("cin,ch,stride", [(32, 64, 2), (64, 64, 1)],
                         ids=["stride2-proj", "stride1"])
def test_resblock_matches_flax(cin, ch, stride):
    """A block on flax's parameters: every output within 2 bf16 ulps of
    flax's and 0.1 ulp on average.  At stride 2, PyTorch's ``padding=1``
    in place of flax's (0, 1) moves the outputs by whole values."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 16, 16, cin)), jnp.float32).astype(jnp.bfloat16)
    block = JaxResBlock(ch, stride)
    params = jax.device_get(jax.jit(block.init)(jax.random.PRNGKey(1), x))
    # non-trivial norm parameters, so their mapping shows
    for gn in ("gn1", "gn2"):
        for leaf, base in (("scale", 1.0), ("bias", 0.0)):
            shape = params["params"][gn][leaf].shape
            params["params"][gn][leaf] = base + 0.1 * rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax.jit(block.apply)(params, x).astype(jnp.float32))

    ours = ResBlock(cin, ch, stride)
    ours.load_state_dict(_flat(params["params"]))
    with torch.no_grad():
        out = ours(torch.tensor(np.asarray(x.astype(jnp.float32))).to(BF16)).float().numpy()
    assert out.shape == ref.shape == (2, 16 // stride, 16 // stride, ch)
    ulps = _ulps(out, ref)
    assert ulps.max() <= 2 and ulps.mean() < 0.1, (ulps.max(), ulps.mean())


def test_group_norm_matches_flax():
    """flax ``GroupNorm(num_groups=8, dtype=bf16)`` (eps 1e-6, f32 stats,
    f32 scale and bias) on bf16 input with a shifted mean: within one bf16
    ulp everywhere."""
    import flax.linen as nn

    rng = np.random.default_rng(1)
    x = jnp.asarray(3.0 + rng.standard_normal((2, 8, 8, 64)), jnp.float32).astype(jnp.bfloat16)
    gn = nn.GroupNorm(num_groups=8, dtype=jnp.bfloat16)
    params = {"params": {"scale": 1 + 0.1 * rng.standard_normal(64).astype(np.float32),
                         "bias": 0.1 * rng.standard_normal(64).astype(np.float32)}}
    ref = np.asarray(jax.jit(gn.apply)(params, x).astype(jnp.float32))
    ours = GroupNorm(64)
    ours.load_state_dict(_flat(params["params"]))
    with torch.no_grad():
        out = ours(torch.tensor(np.asarray(x.astype(jnp.float32))).to(BF16))
    assert out.dtype == BF16 and ours.eps == 1e-6
    assert _ulps(out.float().numpy(), ref).max() <= 1


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(2)
    return (rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 100, size=(2,)).astype(np.int32))


@pytest.fixture(scope="module")
def flax_resnet(images):
    """``flax_resnet(name)``: (flax module, config, flax's init on the
    images), each built once."""
    built = {}

    def get(name):
        if name not in built:
            jmodel, cfg = jax_build_model(name)
            init = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(images[0]))
            built[name] = (jmodel, cfg, jax.device_get(init))
        return built[name]

    return get


@pytest.mark.parametrize("name", ["resnet-tiny", "resnet-mid"])
def test_resnet_logits_match_flax(name, images, flax_resnet):
    """Whole ResNets at batch 2 on flax's parameters: f32 logits within
    4e-3 (about 2 bf16 ulps at their scale, ~1) at the worst entry and
    1e-3 on average."""
    x = jnp.asarray(images[0])
    jmodel, cfg, params = flax_resnet(name)
    ref = np.asarray(jax.jit(jmodel.apply)(params, x))
    model, _ = build_model(name)
    model.load_state_dict(params_from_jax(params, cfg))
    with torch.no_grad():
        out = model(torch.from_numpy(images[0]))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, cfg.num_classes)
    err = np.abs(out.numpy() - ref)
    assert err.max() < 4e-3 and err.mean() < 1e-3, (err.max(), err.mean())


def test_resnet_train_steps_match_jax():
    """Three resnet-tiny train steps from the same transferred init on the
    same three (images, labels) batches: the losses agree with the JAX
    trainer's to 5e-3 (the dense LM's bound)."""
    rng = np.random.default_rng(3)
    batches = [(rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 100, size=(4,)).astype(np.int32)) for _ in range(3)]
    kw = dict(batch_size=4, learning_rate=3e-3)
    jt = JaxTrainer("resnet-tiny", make_mesh(dp=1, devices=jax.devices()[:1]), **kw)
    state = jt.init(seed=0)
    params = jax.device_get(state[0])
    ref = []
    for imgs, labels in batches:
        state, loss = jt.step(state, (jnp.asarray(imgs), jnp.asarray(labels)))
        ref.append(float(loss))

    tr = ShardedTrainer("resnet-tiny", device="cpu", **kw)
    ts = tr.init(seed=0)
    ts.model.load_state_dict(params_from_jax(params, tr.cfg))
    ours = []
    for batch in batches:
        ts, loss = tr.step(ts, tr.to_device(batch))
        ours.append(float(loss))
    assert ours[-1] < ours[0]
    np.testing.assert_allclose(ours, ref, atol=5e-3, rtol=0)


def test_make_batch_and_seq_shard():
    """The trainer's own batch is an (images, labels) pair from a seeded
    generator, the same for the same seed; ``seq_shard`` raises the JAX
    trainer's error; ``seq_len`` is not checked against a CNN."""
    tr = ShardedTrainer("resnet-tiny", batch_size=4, seq_len=10 ** 6, device="cpu")
    images, labels = tr.make_batch(seed=5)
    assert images.shape == (4, 32, 32, 3) and images.dtype == torch.float32
    assert labels.shape == (4,) and labels.dtype == torch.int64
    assert 0 <= int(labels.min()) and int(labels.max()) < 100
    again = tr.make_batch(seed=5)
    assert torch.equal(images, again[0]) and torch.equal(labels, again[1])
    with pytest.raises(ValueError, match="seq_shard applies to LM sequences, not images"):
        ShardedTrainer("resnet-tiny", seq_shard=True, device="cpu")


def test_profile_writes_the_jax_cache(tmp_path, monkeypatch):
    """``profile_model("resnet-tiny", ks=(1, 16, 64))`` measured on the CPU
    writes the entry the JAX package writes for the same measured step,
    byte for byte; k = 16 is faster than k = 1, as in the JAX suite."""
    ours_path, ref_path = tmp_path / "ours.json", tmp_path / "ref.json"
    curve = profile_model("resnet-tiny", ks=(1, 16, 64), batch_size=2,
                          cache=CurveCache(ours_path), device="cpu")
    assert curve.step_time(1) > 0 and curve.step_time(16) < curve.step_time(1)
    step_s = json.loads(ours_path.read_text())["resnet-tiny"]["points"]["1"]
    monkeypatch.setattr(jax_harness, "measure_step_time", lambda *a, **k: step_s)
    jax_harness.profile_model("resnet-tiny", ks=(1, 16, 64), batch_size=2,
                              devices=jax.devices()[:1], cache=jax_goodput.CurveCache(ref_path))
    assert ours_path.read_bytes() == ref_path.read_bytes()
    trace = capture_trace("resnet-tiny", tmp_path / "trace", batch_size=2, steps=1, device="cpu")
    assert json.loads(Path(trace).read_text())["traceEvents"]


def test_bench_child_reports_samples_per_s(capsys):
    """The bench's dense cell on an image model: samples/s, per-sample
    FLOPs (no MFU off a card in CARDS)."""
    from gpuschedule_tpu_torch import bench

    line = bench.child_main("resnet-tiny", device="cpu", batch_size=2, warmup=1, iters=1,
                            repeats=1)
    assert line["unit"] == "samples/s" and line["value"] > 0 and "mfu" not in line
    assert line["metric"].startswith("resnet-tiny train-step samples/s (b2x32x32, 1 device")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line


def test_train_cli_refuses_a_cnn_with_the_jax_message():
    with pytest.raises(SystemExit) as ours:
        main(["train", "--model", "resnet-tiny", "--steps", "1", "--device", "cpu"])
    with pytest.raises(SystemExit) as ref, contextlib.redirect_stdout(io.StringIO()):
        jax_cli.main(["train", "--model", "resnet-tiny", "--steps", "1", "--devices", "1"])
    assert "image models are profile-only for now" in str(ours.value)
    assert str(ours.value) == str(ref.value)


def test_reset_parameters_follows_flax_initialisers(flax_resnet):
    """Per-leaf std of the port's init against flax's, within 4 standard
    errors of the two estimates (a conv kernel's fan-in is kh·kw·cin);
    zero biases and unit norm scales exact."""
    _, cfg, params = flax_resnet("resnet-tiny")
    ref = params_from_jax(params, cfg)
    model, _ = build_model("resnet-tiny")
    model.reset_parameters(torch.Generator().manual_seed(0))
    ours = model.state_dict()
    assert ours.keys() == ref.keys()
    for name, val in ours.items():
        std, ref_std = float(val.std()), float(ref[name].std())
        if ref_std == 0.0:
            assert torch.equal(val, ref[name]), name
        else:
            assert std == pytest.approx(ref_std, rel=4 / math.sqrt(val.numel())), name
    stem = model.stem.kernel
    assert float(stem.detach().std()) == pytest.approx(1 / math.sqrt(3 * 3 * 3), rel=0.15)
