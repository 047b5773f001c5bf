"""Port parity for the profile path: the own copies of the slice table, the
ICI/DCN model and the goodput curves against the JAX package, and
``profile_model`` writing the very cache the JAX package writes.

The copies are held equal to the originals on a grid of inputs (same
arithmetic, so exact equality).  ``profile_model`` is compared with both
sides' ``measure_step_time`` replaced by one constant: what is left is the
synthesis, the fit and the cache format, which must give byte-identical
JSON.  Then the unpatched path runs on the CPU at transformer-tiny's size,
through the API and the CLI, with a trace.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from gpuschedule_tpu.cluster import tpu as jax_tpu  # noqa: E402
from gpuschedule_tpu.profiler import goodput as jax_goodput  # noqa: E402
from gpuschedule_tpu.profiler import harness as jax_harness  # noqa: E402
from gpuschedule_tpu.profiler import ici as jax_ici  # noqa: E402
from gpuschedule_tpu_torch.cli import main  # noqa: E402
from gpuschedule_tpu_torch.cluster import tpu  # noqa: E402
from gpuschedule_tpu_torch.profiler import (  # noqa: E402
    CurveCache,
    capture_trace,
    goodput,
    harness,
    ici,
    profile_model,
)

GENS = sorted(jax_tpu.GENERATIONS)
KS = (1, 2, 4, 8, 16, 32, 64)


def test_interconnect_constants_match():
    assert tpu.GENERATIONS == jax_tpu.GENERATIONS
    assert tpu.DCN_GBPS == jax_tpu.DCN_GBPS
    assert ici.LATENCY_S == jax_ici.LATENCY_S
    fields = [(f.name, f.type) for f in dataclasses.fields(tpu.SliceGeometry)]
    assert fields == [(f.name, f.type) for f in dataclasses.fields(jax_tpu.SliceGeometry)]


@pytest.mark.parametrize("gen", GENS)
def test_slice_shapes_match(gen):
    dims = jax_tpu.GENERATIONS[gen]["pod_dims"]
    for n in list(range(0, 20)) + [2 ** e for e in range(10)]:
        assert tpu.valid_slice_shapes(n, dims) == jax_tpu.valid_slice_shapes(n, dims), n
        assert tpu._is_pow2(n) == jax_tpu._is_pow2(n)
    geom = tpu.SliceGeometry(0, (0, 1), (2, 2), (False, False))
    assert list(geom.chips()) == list(jax_tpu.SliceGeometry(0, (0, 1), (2, 2), (False, False)).chips())
    assert geom.num_chips == 4


def test_ici_functions_match():
    for nbytes in (0.0, 1e3, 3.3e7, 1.4e9):
        for k in (0, 1, 2, 3, 16, 256):
            for gbps in (100.0, 400.0, 800.0):
                for bidir in (False, True):
                    kw = dict(link_gbps=gbps, bidirectional=bidir)
                    assert ici.allreduce_seconds(nbytes, k, **kw) == jax_ici.allreduce_seconds(nbytes, k, **kw)
        for pods in (0, 1, 2, 5):
            for dcn in (0.0, 25.0, 100.0):
                assert (ici.cross_pod_allreduce_seconds(nbytes, pods, dcn_gbps=dcn)
                        == jax_ici.cross_pod_allreduce_seconds(nbytes, pods, dcn_gbps=dcn))
            assert ici.cross_pod_allreduce_seconds(nbytes, pods) == jax_ici.cross_pod_allreduce_seconds(nbytes, pods)
        for gen in GENS:
            dims = jax_tpu.GENERATIONS[gen]["pod_dims"]
            for shape in tpu.valid_slice_shapes(16, dims) + [tuple(dims)]:
                wraps = tuple(s == d for s, d in zip(shape, dims))
                ours = tpu.SliceGeometry(0, (0,) * len(shape), shape, wraps)
                ref = jax_tpu.SliceGeometry(0, (0,) * len(shape), shape, wraps)
                assert (ici.slice_allreduce_seconds(nbytes, ours, generation=gen)
                        == jax_ici.slice_allreduce_seconds(nbytes, ref, generation=gen))
    for p in (0, 1, 123457, 352321536):
        assert ici.dp_gradient_bytes(p) == jax_ici.dp_gradient_bytes(p)
        assert ici.dp_gradient_bytes(p, dtype_bytes=2) == jax_ici.dp_gradient_bytes(p, dtype_bytes=2)


def test_fit_and_mape_match():
    rng = np.random.default_rng(0)
    ks = [1, 2, 3, 4, 6, 8, 12, 16, 32, 64]
    for theta in ((0.5, 0.01, 1e-4), (0.2, 0.0, 0.0), (0.0, 0.3, 2e-3)):
        times = [(theta[0] / k + theta[1] + theta[2] * (k - 1)) * (1 + 0.05 * rng.standard_normal())
                 for k in ks]
        times = [max(t, 1e-6) for t in times]
        ours = goodput.fit_step_time_curve(ks, times)
        ref = jax_goodput.fit_step_time_curve(ks, times)
        assert ours.theta == ref.theta
        assert goodput.mape(ours, ks, times) == jax_goodput.mape(ref, ks, times)
    for bad in (([], []), ([1, 2], [1.0]), ([0], [1.0]), ([1], [0.0])):
        with pytest.raises(ValueError):
            goodput.fit_step_time_curve(*bad)


@pytest.mark.parametrize("gen", GENS)
def test_synthesize_step_times_matches(gen):
    for unit, ks in ((1, [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024]), (2, [2, 4, 64, 512])):
        kw = dict(single_chip_step_s=0.13, param_count=352321536, generation=gen, ks=ks, unit=unit)
        assert goodput.synthesize_step_times(**kw) == jax_goodput.synthesize_step_times(**kw)
    for ks in ([3], [384]):  # not a slice size; not whole pods
        with pytest.raises(ValueError):
            goodput.synthesize_step_times(single_chip_step_s=0.1, param_count=1000,
                                          generation=gen, ks=ks)


@pytest.fixture
def constant_step(monkeypatch):
    """Both packages' measure_step_time return the same constant."""
    step_s = 0.0123456789
    monkeypatch.setattr(harness, "measure_step_time", lambda *a, **k: step_s)
    monkeypatch.setattr(jax_harness, "measure_step_time", lambda *a, **k: step_s)
    return step_s


@pytest.mark.parametrize("gen", GENS)
def test_profile_model_writes_the_jax_cache(constant_step, tmp_path, gen):
    """Port (device="cpu") and JAX (one device) write byte-identical cache
    JSON for the same measured step; the JAX CurveCache reads the port's
    file to the same step times, on and off the pod."""
    ours_path, ref_path = tmp_path / "ours.json", tmp_path / "ref.json"
    for model in ("transformer-tiny", "transformer-large"):
        ours = profile_model(model, ks=KS, generation=gen, cache=CurveCache(ours_path), device="cpu")
        ref = jax_harness.profile_model(model, ks=KS, generation=gen, devices=jax.devices()[:1],
                                        cache=jax_goodput.CurveCache(ref_path))
        assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
    assert ours_path.read_bytes() == ref_path.read_bytes()
    entry = json.loads(ours_path.read_text())["transformer-large"]
    assert entry["source"] == f"measured<= 1 chips (sp=1, tp=1, pp=1), analytic beyond ({gen})"
    assert entry["points"]["1"] == constant_step
    loaded = jax_goodput.CurveCache(ours_path)
    for model in ("transformer-tiny", "transformer-large"):
        curve, ref = loaded.get(model), CurveCache(ours_path).get(model)
        assert curve.multislice_aware
        for k in list(KS) + [256, 512, 1024]:
            assert curve.step_time(k) == ref.step_time(k)
            assert curve.step_time_dcn(k) == ref.step_time_dcn(k)


def test_profile_model_beyond_one_pod(constant_step, tmp_path):
    """ks wholly beyond one pod: both sides add the measured k = 1 point
    (the anchor of the synthesis), fit on it alone and write the same
    cache."""
    ks = (512, 1024)
    ours = profile_model("transformer-small", ks=ks, cache=CurveCache(tmp_path / "a.json"), device="cpu")
    ref = jax_harness.profile_model("transformer-small", ks=ks, devices=jax.devices()[:1],
                                    cache=jax_goodput.CurveCache(tmp_path / "b.json"))
    assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()


def test_profile_model_on_cpu(tmp_path):
    """The unpatched path: one measured step of transformer-tiny on the CPU,
    the other ks synthesized, a non-negative fit stored in the cache."""
    path = tmp_path / "curves.json"
    curve = profile_model("transformer-tiny", batch_size=2, seq_len=32, cache=CurveCache(path),
                          device="cpu")
    assert all(math.isfinite(t) and t >= 0 for t in curve.theta)
    entry = json.loads(path.read_text())["transformer-tiny"]
    assert sorted(int(k) for k in entry["points"]) == list(KS)
    assert entry["points"]["1"] > 0
    assert jax_goodput.CurveCache(path).get("transformer-tiny").theta == curve.theta


def test_profile_cli_and_trace(tmp_path, capsys):
    """``profile --device cpu`` prints theta per model and, with
    ``--trace-dir``, the path of a Chrome trace it wrote."""
    curves, traces = tmp_path / "curves.json", tmp_path / "traces"
    assert main(["profile", "--model", "transformer-tiny", "--ks", "1,2,4", "--batch-size", "2",
                 "--seq-len", "32", "--curves", str(curves), "--trace-dir", str(traces),
                 "--device", "cpu"]) == 0
    theta, trace = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert theta["model"] == "transformer-tiny" and len(theta["theta"]) == 3
    assert json.loads(curves.read_text())["transformer-tiny"]["theta"] == theta["theta"]
    assert trace == {"model": "transformer-tiny", "trace": str(traces / "transformer-tiny" / "trace.json")}
    assert json.loads((traces / "transformer-tiny" / "trace.json").read_text())["traceEvents"]
    path = capture_trace("transformer-tiny", tmp_path / "t2", batch_size=2, seq_len=16, steps=1,
                         device="cpu")
    assert json.loads(open(path).read())["traceEvents"]
