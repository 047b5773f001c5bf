"""The port's bench (``gpuschedule_tpu_torch/bench.py``) on the CPU, against
the JAX package's root ``bench.py`` where the two share a contract.

The root bench is imported for its pure formatter only (it imports JAX
inside its children, never at module level).  The port's children run
in-process at tiny sizes with ``device="cpu"``, where the kernels' plain
versions stand in and no line may claim an MFU.
"""

import json
import math
import sys
from pathlib import Path

import pytest
import torch

from gpuschedule_tpu_torch import bench
from gpuschedule_tpu_torch.parallel import ShardedTrainer

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench as jax_bench  # noqa: E402  the JAX package's bench, root of the repo

MODEL = "transformer-tiny"
H100 = "NVIDIA H100 80GB HBM3"
# the JAX bench's child_main line on and off the TPU (bench.py:153-162)
REFERENCE_MAIN_KEYS = {"metric", "value", "unit", "vs_baseline", "backend"}
PORT_EXTRA_KEYS = {"device", "power_limit_w", "step_ms"}


def _only_line(capsys) -> dict:
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize(
    "backend, kind",
    [("cuda", H100), ("cuda", "NVIDIA H100 PCIe"), ("cpu", "cpu")],
    ids=["h100-sxm", "card-not-in-CARDS", "cpu"],
)
def test_flash_line_matches_the_reference(backend, kind):
    """Same inputs, same keys and numbers as the JAX bench's ``_flash_line``:
    with ``mfu`` and a proportional ``vs_baseline`` on a card with known
    peaks (the TPU on the reference side), without ``mfu`` and with
    ``vs_baseline`` 0 anywhere else."""
    kw = dict(model="m", seq=4096, s_time=4096, achieved_tflops=98.9, tokens_per_s=1234.56,
              kernel_speedup=2.345, device_speedup=5.6, fwd_err=1.23456e-3, bwd_err=2e-3)
    on_card = kind == H100
    ref = jax_bench._flash_line(
        backend="tpu" if on_card else "cpu", device_kind="tpu v5 lite", compiled=on_card,
        generations={"v5e": {"bf16_tflops": 197.0}, "v5p": {"bf16_tflops": 459.0}}, **kw)
    ours = bench._flash_line(backend=backend, device_kind=kind, compiled=backend == "cuda", **kw)
    assert set(ours) == set(ref)
    for key in ("value", "unit", "kernel_speedup_vs_dense", "kernel_speedup_vs_dense_device",
                "fwd_maxerr", "bwd_relerr"):
        assert ours[key] == ref[key], key
    assert ours["backend"] == backend and ours["compiled"] == (backend == "cuda")
    assert bench.TARGET_MFU == jax_bench.TARGET_MFU
    if on_card:
        assert ours["mfu"] == pytest.approx(0.1, abs=1e-3)
        assert ours["vs_baseline"] == round(98.9e12 / 989e12 / bench.TARGET_MFU, 3)
        assert "on h100-sxm: mfu=0.100" in ours["metric"]
    else:
        assert "mfu" not in ours and ours["vs_baseline"] == 0.0 == ref["vs_baseline"]


@pytest.mark.parametrize("cell", ["main", "flash", "longctx"])
def test_children_run_on_cpu(cell, capsys):
    """Each cell end to end on the CPU at a tiny size: one parseable line
    (the long-context cell also one before its dense probe), no MFU."""
    small = dict(device="cpu", warmup=2, iters=1, repeats=1)
    if cell == "main":
        line = bench.child_main(MODEL, batch_size=2, seq_len=32, **small)
        assert set(line) == REFERENCE_MAIN_KEYS | PORT_EXTRA_KEYS
    elif cell == "flash":
        line = bench.child_flash(MODEL, parity_seq=128, seq_len=64, **small)
        assert line["fwd_maxerr"] < bench.PARITY_TOL and line["bwd_relerr"] < bench.PARITY_TOL
        assert line["compiled"] is False and line["kernel_speedup_vs_dense_device"] is None
        assert set(line["launches"].values()) == {0}  # no kernel runs off the card
    else:
        line = bench.child_longctx(MODEL, seq_len=64, **small)
        assert line["seq_len"] == 64 and line["dense_feasible"] is True
        assert math.isfinite(line["loss"])
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert out[-1] == line
    assert len(out) == (2 if cell == "longctx" else 1)
    if cell == "longctx":
        assert out[0]["dense_feasible"] is None and out[0]["value"] == line["value"]
    assert line["backend"] == "cpu" and line["device"] == "cpu" and line["value"] > 0
    assert "mfu" not in line and line["vs_baseline"] == 0.0


def test_dense_probe_reads_only_an_out_of_memory_error(monkeypatch):
    """``dense_feasible`` is false only for ``torch.cuda.OutOfMemoryError``
    by type; any other failure, even one whose message reads like an OOM,
    is raised."""
    assert bench.dense_probe(MODEL, 32, device="cpu") is True

    def oom(self, state, tokens):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 17.18 GiB")

    monkeypatch.setattr(ShardedTrainer, "step", oom)
    assert bench.dense_probe(MODEL, 32, device="cpu") is False

    def other(self, state, tokens):
        raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

    monkeypatch.setattr(ShardedTrainer, "step", other)
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        bench.dense_probe(MODEL, 32, device="cpu")


MAIN_LINE = {"metric": "m", "value": 1.0, "unit": "tokens/s", "vs_baseline": 0.0,
             "backend": "cpu"}


@pytest.mark.parametrize("fault", ["main-fails", "extra-fails", "extras-skipped"])
def test_a_failed_or_skipped_cell_gives_one_line_and_a_nonzero_exit(fault, monkeypatch, capsys):
    seen = []

    def attempt(argv, timeout_s):
        kind = argv[argv.index("--child") + 1]
        seen.append(kind)
        if kind == "main" and fault != "main-fails":
            return dict(MAIN_LINE), ""
        return None, "rc=1 at stage 'setup' (boom)"

    monkeypatch.setattr(bench, "_run_attempt", attempt)
    if fault == "extras-skipped":
        monkeypatch.setattr(bench, "TOTAL_BUDGET_S", 0.0)
    rc = bench.main(["--device", "cpu", "--model", MODEL, "--flash-model", MODEL,
                     "--longctx-model", MODEL])
    line = _only_line(capsys)
    assert rc == 1
    if fault == "main-fails":
        assert seen == ["main"] and "boom" in line["failed"] and line["value"] == 0.0
    elif fault == "extra-fails":
        assert seen == ["main", "flash", "longctx"]
        assert "boom" in line["flash"]["failed"] and "boom" in line["longctx"]["failed"]
    else:
        assert seen == ["main"]
        assert "budget" in line["flash"]["skipped"] and "budget" in line["longctx"]["skipped"]


def test_extras_fold_into_the_line_and_run_off_the_card_only_when_named(monkeypatch, capsys):
    subs = {"flash": {"metric": "f", "value": 2.0, "fwd_maxerr": 1e-6, "bwd_relerr": 1e-6,
                      "compiled": False, "launches": {}},
            "longctx": {"metric": "l", "value": 3.0, "seq_len": 64, "dense_feasible": True,
                        "loss": 8.0}}
    seen = []

    def attempt(argv, timeout_s):
        kind = argv[argv.index("--child") + 1]
        seen.append(argv)
        return (dict(MAIN_LINE) if kind == "main" else dict(subs[kind])), ""

    monkeypatch.setattr(bench, "_run_attempt", attempt)
    assert bench.main(["--device", "cpu", "--model", MODEL]) == 0
    assert "flash" not in _only_line(capsys) and len(seen) == 1

    assert bench.main(["--device", "cpu", "--model", MODEL, "--flash-model", MODEL,
                       "--longctx-model", MODEL, "--longctx-seq", "64"]) == 0
    line = _only_line(capsys)
    assert line["flash"]["tokens_per_s"] == 2.0 and line["flash"]["model"] == MODEL
    assert line["longctx"]["seq_len"] == 64 and line["longctx"]["dense_feasible"] is True
    assert seen[-1][-2:] == ["--longctx-seq", "64"] and "--device" in seen[-1]


def test_run_attempt_times_out_and_reads_the_last_line(tmp_path):
    """The real subprocess path: a child past its timeout is killed and
    reported with its last stage; a child that exits 0 gives its last JSON
    line; one that exits non-zero is a failure, whatever it printed."""
    script = tmp_path / "child.py"
    script.write_text(
        "import json, sys, time\n"
        "print('STAGE: sleeping', file=sys.stderr, flush=True)\n"
        "print(json.dumps({'metric': 'first', 'value': 1.0}), flush=True)\n"
        "print(json.dumps({'metric': 'last', 'value': 2.0}), flush=True)\n"
        "mode = sys.argv[1]\n"
        "if mode == 'hang': time.sleep(60)\n"
        "sys.exit(3 if mode == 'fail' else 0)\n"
    )
    parsed, note = bench._run_attempt([sys.executable, str(script), "ok"], 30)
    assert parsed == {"metric": "last", "value": 2.0} and note == ""
    parsed, note = bench._run_attempt([sys.executable, str(script), "fail"], 30)
    assert parsed is None and note.startswith("rc=3")
    parsed, note = bench._run_attempt([sys.executable, str(script), "hang"], 1)
    assert parsed is None and note == "timeout 1s at stage 'sleeping'"


def test_card_table():
    """The H100 SXM's published peaks, the names that find them, and the
    power limit as nvidia-smi prints it; a card not in the table gets none."""
    from gpuschedule_tpu_torch.cluster.cards import CARDS, detect_card, power_limit_w

    assert CARDS["h100-sxm"]["bf16_flops"] == 989e12
    assert CARDS["h100-sxm"]["bytes_per_s"] == 3.35e12
    assert detect_card(H100) == detect_card("NVIDIA H100 SXM5 80GB") == "h100-sxm"
    for other in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB", "cpu"):
        assert detect_card(other) is None
    assert power_limit_w("NVIDIA H100 80GB HBM3, 700.00 W") == 700.0
    assert power_limit_w("NVIDIA H100 80GB HBM3, [N/A]") is None
