"""Port parity for the tools: ``gpuschedule_tpu_torch.tools.roofline``,
``kernel_bench`` and ``trace_flash`` against ``tools/roofline.py``,
``tools/kernel_bench.py`` and ``tools/trace_flash.py`` on the CPU, and the
profiler window they share (``profiler.harness.device_window``).

The arithmetic the two packages share is held equal: ``visited_tiles``,
``attn_flops``, ``fit_overhead``'s attribution and ``device_times``'s
aggregation (the JAX side's from a chrome trace holding the same records).
The port's own rules are pinned: the visited tiles of the CUDA kernels'
loop bounds, counted one block at a time, and the bounds PERF.md's kernel
table and ``chip_smoke.py`` hold each kernel to.  The tools run their CPU
path at (1, 128, 2, 32): the JAX tools' case names and keys, the flash
cases through the plain versions.  ``device_window``'s retaking runs on a
stand-in profiler; the card's windows are ``chip_smoke.py``'s phase 19.
"""

import gzip
import importlib.util
import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from gpuschedule_tpu_torch.cluster.cards import CARDS  # noqa: E402
from gpuschedule_tpu_torch.profiler import harness  # noqa: E402
from gpuschedule_tpu_torch.profiler.harness import LostWindow, Record, device_window  # noqa: E402
from gpuschedule_tpu_torch.tools import kernel_bench, roofline, trace_flash  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_roofline = _jax_tool("roofline")
jax_kernel_bench = _jax_tool("kernel_bench")
jax_trace_flash = _jax_tool("trace_flash")

H100 = CARDS["h100-sxm"]
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s_pad, bq, bk", [(64, 64, 64), (640, 64, 64), (4096, 64, 64),
                                           (1024, 128, 256), (1024, 256, 128),
                                           (4096, 512, 1024)])
def test_visited_tiles_is_the_jax_tools(s_pad, bq, bk, causal):
    assert roofline.visited_tiles(s_pad, bq, bk, causal) == \
        jax_roofline.visited_tiles(s_pad, bq, bk, causal)


@pytest.mark.parametrize("shape", [(2, 4096, 8, 32), (2, 4096, 8, 128), (1, 128, 2, 32),
                                   (1, 32768, 8, 64)])
def test_attn_flops_is_the_jax_tools(shape):
    for causal in (True, False):
        assert kernel_bench.attn_flops(*shape, causal) == jax_kernel_bench.attn_flops(*shape, causal)


def test_fit_overhead_attributes_the_gap_as_the_jax_tool_does():
    """The same analysis in both forms (JAX's grid steps as the port's tile
    visits) gives the same gap and the same cost per unit."""
    a = jax_roofline.analyze(2, 4096, 8, 128)
    ours = roofline.fit_overhead(3.5, {"roofline_fwdbwd_ms": a["roofline_fwdbwd_ms"],
                                       "tile_visits": a["grid_steps"]})
    theirs = jax_roofline.fit_overhead(3.5, a)
    assert ours["total_tile_visits"] == theirs["total_grid_steps"]
    assert round(ours["gap_ms"], 3) == theirs["gap_ms"]
    assert round(ours["implied_us_per_tile"], 3) == theirs["implied_us_per_step"]


def test_function_bounds_are_the_kernel_tables():
    """PERF.md's bound column (ms, four places; K1-K3 at the main, long,
    tp and pp shapes, the probe kernels at n = 4096) and the bounds
    chip_smoke's phase 19 holds the roofline to."""
    table = {(2, 4096, 8, 32): (0.0174, 0.0261, 0.0348),
             (1, 32768, 8, 64): (1.1118, 1.6677, 2.2235),
             (1, 4096, 4, 32): (0.0043, 0.0065, 0.0087),
             (1, 4096, 8, 32): (0.0087, 0.0130, 0.0174)}
    for shape, want in table.items():
        got = tuple(round(roofline.bound(*roofline.attention_cost(*shape, True, 2, k), H100)[0], 4)
                    for k in KERNELS)
        assert got == want, shape
        assert roofline.analyze(*shape)["function"]["flash_fwd"]["bound_ms"] == \
            pytest.approx(want[0], abs=5e-5)
    for shape, want in chip_smoke.SECTION6_BOUNDS.items():
        assert want == table[shape]
    for kernel in ("probe_copy", "probe_matmul"):
        ms, by = roofline.bound(*roofline.probe_cost(4096, 128, kernel), H100)
        assert (round(ms, 4), by) == (0.0050, "bytes")
    # the f32 forms write 4 bytes an element: PERF.md's chunk-pair bounds
    past = [round(roofline.bound(*roofline.attention_cost(1, 8192, 8, 64, False, 2, f"{k}_f32", 4),
                                 H100)[0], 4) for k in KERNELS]
    assert past == [0.1390, 0.2085, 0.2779]


def _cuda_tile_visits(s, causal):
    """The tiles the CUDA kernels visit for one (b, h), from their loop
    bounds block by block: K1 and K2 run q tile qi over key tiles up to
    ``kend = min(S, q0 + BQ)``; K3 runs key tile kb over q tiles from
    ``qstart = k0``."""
    t = 64
    nq = -(-s // t)
    fwd = sum(-(-(min(s, qi * t + t) if causal else s) // t) for qi in range(nq))
    dkdv = sum(-(-(s - (kb * t if causal else 0)) // t) for kb in range(nq))
    return fwd, dkdv


@pytest.mark.parametrize("s", [1, 63, 64, 65, 200, 1000, 4096])
def test_analyze_visits_the_cuda_kernels_tiles(s):
    for causal in (True, False):
        fwd, dkdv = _cuda_tile_visits(s, causal)
        a = roofline.analyze(2, s, 3, 32, causal=causal)
        assert a["visited_tiles"] == fwd == dkdv
        assert a["tile_visits"] == {k: 6 * fwd for k in KERNELS}
        assert a["executed_over_function_flops"] >= 1
        assert a["executed_gflops"]["flash_bwd_dkdv"] == \
            pytest.approx(fwd * 6 * 4 * 2 * 64 * 64 * 32 / 1e9)


def test_analyze_refuses_what_the_kernels_are_not_built_for():
    with pytest.raises(ValueError, match="head dim 48"):
        roofline.analyze(1, 128, 2, 48)
    with pytest.raises(SystemExit):
        roofline.main(["--blocks", "128,128"])


def _case_names(rows_or_records, prefix=""):
    return [r["case"].removeprefix(prefix) for r in rows_or_records]


def test_kernel_bench_on_the_cpu_runs_the_jax_tools_cases(capsys):
    rows = kernel_bench.run(1, 128, 2, 32, torch.bfloat16, device="cpu", iters=2, warmup=1)
    prefix = f"b1s128h2d32 {jnp.dtype(jnp.bfloat16).name} "
    assert _case_names(rows, prefix) == [
        "dense fwd", "dense fwd+bwd", "flash fwd bq64 bk64", "flash fwd+bwd bq64 bk64",
        "sdpa fwd", "sdpa fwd+bwd"]
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows
    for row in rows:
        assert {"case", "ms", "tflops"} <= set(row)  # the JAX tool's keys
        assert row["ms"] > 0 and row["device_ms"] is None  # no device time off the card
        assert row["launches"] == dict.fromkeys(KERNELS, 0.0)  # the plain versions ran
    assert [r["route"] for r in rows] == ["dense", "dense", "plain", "plain",
                                          "library", "library"]
    fl = kernel_bench.attn_flops(1, 128, 2, 32)
    assert rows[1]["tflops"] == pytest.approx(3.5 * fl / (rows[1]["ms"] / 1e3) / 1e12)
    assert rows[3]["bound_ms"] == pytest.approx(sum(
        roofline.bound(*roofline.attention_cost(1, 128, 2, 32, True, 2, k), H100)[0]
        for k in KERNELS))


def test_kernel_bench_cases_compute_attention():
    """Each case's forward (fwd) and gradients (fwd+bwd) agree with the
    dense oracle's on the CPU: the plain flash versions and SDPA."""
    q, k, v = kernel_bench.inputs(1, 128, 2, 32, torch.float32, "cpu")
    cases = kernel_bench.cases(q, k, v)
    ref_out = cases["dense fwd"][0]()
    ref_grads = cases["dense fwd+bwd"][0]()
    for name in ("flash fwd bq64 bk64", "sdpa fwd"):
        assert torch.allclose(cases[name][0](), ref_out, atol=1e-5), name
    for name in ("flash fwd+bwd bq64 bk64", "sdpa fwd+bwd"):
        for got, ref in zip(cases[name][0](), ref_grads):
            assert torch.allclose(got, ref, atol=1e-4), name


def test_trace_flash_on_the_cpu_runs_the_jax_tools_cases(capsys):
    records = trace_flash.main(["--device", "cpu", "--shape", "1,128,2,32"])
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert out[0] == {"backend": "cpu", "device": "cpu", "card": None}
    assert out[1:] == records
    assert _case_names(records) == ["dense fwd+bwd", "flash fwd+bwd bq64 bk64"]
    for rec in records:
        assert {"case", "iters", "device_ms_per_iter", "top_device_ops_ms_per_iter"} <= set(rec)
        assert rec["device_ms_per_iter"] is None and rec["iters"] == jax_trace_flash.ITERS


def test_device_times_aggregates_as_the_jax_tool_does(tmp_path):
    """One window's records through the port's ``device_times`` and, written
    as the xprof chrome trace the JAX tool reads, through its own: the same
    ms per iteration and top operations (names cut to 48 characters)."""
    long = "void (anonymous namespace)::dkdv_mma_kernel<128, __nv_bfloat16>(args)"
    durations = {long: 6073.7, "dq_mma_kernel": 5113.2, "fwd_mma_kernel": 3224.1,
                 "elementwise a": 871.5, "elementwise b": 796.3, "copy": 638.3, "tiny": 12.0}
    records = [Record(name, us / 2) for name, us in durations.items() for _ in range(2)]
    ours = trace_flash.device_times(records, iters=10)
    events = [{"ph": "M", "pid": 7, "name": "process_name", "args": {"name": "/device:TPU:0"}},
              {"ph": "X", "pid": 7, "name": "jit_loss", "dur": sum(durations.values())}]
    events += [{"ph": "X", "pid": 7, "name": r.name, "dur": r.us} for r in records]
    events += [{"ph": "X", "pid": 7, "name": "3", "dur": 1.0}]  # an xprof step marker
    with gzip.open(tmp_path / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    theirs = jax_trace_flash.device_times(str(tmp_path), iters=10)
    assert round(ours["device_ms_per_iter"], 3) == theirs["device_ms_per_iter"]
    assert {k: round(v, 3) for k, v in ours["top_device_ops_ms_per_iter"].items()} == \
        theirs["top_device_ops_ms_per_iter"]
    assert list(ours["top_device_ops_ms_per_iter"])[0] == long[:48]
    assert "tiny" not in ours["top_device_ops_ms_per_iter"]
    # a window that lost its device records
    assert trace_flash.device_times([], iters=10) == {"error": "the window holds no device record"}


class _Profiles:
    """A stand-in for ``torch.profiler.profile`` whose windows hold the
    records given, one list a window, in turn; a marker is kept only where
    its window says so."""

    def __init__(self, windows):
        self.windows = list(windows)

    def __call__(self, activities):
        records = self.windows.pop(0)
        prof = SimpleNamespace(events=lambda: [
            SimpleNamespace(name=name, device_type=torch.autograd.DeviceType.CUDA,
                            is_user_annotation=False,
                            time_range=SimpleNamespace(elapsed_us=lambda us=us: us))
            for name, us in records])

        class _Window:
            def __enter__(self):
                return prof

            def __exit__(self, *exc):
                return False

        return _Window()


def _stand_in(monkeypatch, windows):
    monkeypatch.setattr(torch.profiler, "profile", _Profiles(windows))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(harness, "TALLY", {"taken": 0, "lost": 0})


def test_device_window_takes_a_lost_window_again(monkeypatch, capsys):
    marker = ("spin_kernel", 20.0)
    pads = [("spin_kernel", 0.5)] * harness.PAD
    kept = [("fwd_mma_kernel", 100.0), ("fwd_mma_kernel", 101.0)]
    _stand_in(monkeypatch, [kept, pads + kept, pads + [marker] + kept])
    calls = []
    win = device_window(lambda: calls.append(1), 2, what="test")
    assert win.device == [Record(*r) for r in kept] and win.lost == 2
    assert len(calls) == 1 + 3 * 2  # one call outside the windows, then each window's two
    assert harness.TALLY == {"taken": 3, "lost": 2}
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and all("lost its marker" in line for line in err)


def test_device_window_retakes_with_the_other_ranks(monkeypatch, capsys):
    """Ranks that step together take a window again together: ``agree``
    gets this rank's verdict on every window and returns every rank's, so
    a window kept here but lost on another rank is taken again here too;
    a run of windows some rank lost raises."""
    marker = ("spin_kernel", 20.0)
    kept = [("fwd_mma_kernel", 100.0)]
    _stand_in(monkeypatch, [[marker] + kept, kept, [marker] + kept])
    seen, others = [], iter([False, True, True])

    def agree(ok):
        seen.append(ok)
        return next(others) and ok

    calls = []
    win = device_window(lambda: calls.append(1), 1, what="test", warm=False, agree=agree)
    assert seen == [True, False, True] and win.lost == 2 and len(calls) == 3
    assert win.device == [Record(*r) for r in kept]
    err = capsys.readouterr().err.splitlines()
    assert "lost another rank's" in err[0] and "lost its marker" in err[1]
    _stand_in(monkeypatch, [[marker] + kept] * harness.WINDOWS)
    with pytest.raises(LostWindow, match=f"{harness.WINDOWS} profiler windows"):
        device_window(lambda: None, 1, what="test", agree=lambda ok: False)


def test_device_window_gives_up_after_its_windows(monkeypatch):
    _stand_in(monkeypatch, [[("fwd_mma_kernel", 1.0)]] * harness.WINDOWS)
    with pytest.raises(LostWindow, match=f"{harness.WINDOWS} profiler windows"):
        device_window(lambda: None, 1, what="test")
    _stand_in(monkeypatch, [[("spin_kernel", 20.0), ("other", 1.0)], [("other", 1.0)]])
    win = device_window(lambda: None, 1, check=False, warm=False)  # the first window as it is
    assert win.lost == 0 and win.device == [Record("other", 1.0)]
    _stand_in(monkeypatch, [[("spin_kernel", 20.0), ("other", 1.0)]] * harness.WINDOWS)
    assert harness.device_ms_per_launch(lambda: None, "fwd_mma_kernel") == (None, [])
    _stand_in(monkeypatch, [[("spin_kernel", 20.0), ("fwd_mma_kernel", 400.0)]])
    ms, names = harness.device_ms_per_launch(lambda: None, "fwd_mma_kernel", launches=4)
    assert math.isclose(ms, 0.1) and names == ["fwd_mma_kernel"]
