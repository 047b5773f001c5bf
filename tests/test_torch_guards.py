"""Guards of the port: the device rule, unported options, import isolation."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gpuschedule_tpu_torch import resolve_device
from gpuschedule_tpu_torch.cli import main
from gpuschedule_tpu_torch.cluster import SimpleCluster
from gpuschedule_tpu_torch.models import MODEL_CONFIGS, CnnConfig, build_model
from gpuschedule_tpu_torch.parallel import ShardedTrainer
from gpuschedule_tpu_torch.parallel.tp import Tp
from gpuschedule_tpu_torch.policies import OptimusPolicy
from gpuschedule_tpu_torch.ops.overhead_probe import probe_copy
from gpuschedule_tpu_torch.profiler import measure_step_time, profile_model
from gpuschedule_tpu_torch.sim import Simulator
from gpuschedule_tpu_torch.sim.trace import generate_poisson_trace
from gpuschedule_tpu_torch.tools.overhead_probe import run_grid

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "gpuschedule_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "gpuschedule_tpu"}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedTrainer("transformer-tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_step_time("transformer-tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_model("transformer-tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_grid(64, kernel=probe_copy)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["train", "--model", "transformer-tiny", "--steps", "1"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["profile", "--model", "transformer-tiny", "--curves", str(tmp_path / "c.json")])
    assert not (tmp_path / "c.json").exists()
    # the simulator's replay is host code; Optimus's online profiling is not
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["run", "--policy", "optimus", "--online", "--curves", str(tmp_path / "c.json"),
              "--synthetic", "5"])
    assert not (tmp_path / "c.json").exists()
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["whatif", "--policy", "optimus", "--online", "--curves", str(tmp_path / "c.json"),
              "--synthetic", "5", "--at", "0", "--swap-policy", "fifo"])
    assert not (tmp_path / "c.json").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulator(SimpleCluster(8), OptimusPolicy(online=True),
                  generate_poisson_trace(3, models=("transformer-tiny",))).run()


def test_bench_has_no_cpu_fallback(no_cuda, capsys):
    """With no card, the bench's default run measures nothing anywhere: it
    prints one failed line and exits non-zero, and a child raises."""
    from gpuschedule_tpu_torch import bench

    for argv in ([], ["--flash-smoke"], ["--longctx"]):
        assert bench.main(argv) == 1
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 1 and "no CUDA device" in json.loads(lines[0])["failed"]
    for child in (bench.child_main, bench.child_flash, bench.child_longctx):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            child("transformer-tiny")


def test_scans_cover_the_bench_and_the_card_table():
    """The import scans below cover these files, the data, checkpoint and
    tracer modules among them, and the simulator's modules: its topology,
    fabric and fault modules, v2 accounting, snapshots, the config-hash
    table and the event stream's readers too."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"gpuschedule_tpu_torch/bench.py", "gpuschedule_tpu_torch/cluster/cards.py",
            "gpuschedule_tpu_torch/models/cnn.py", "gpuschedule_tpu_torch/data/loader.py",
            "gpuschedule_tpu_torch/parallel/checkpoint.py",
            "gpuschedule_tpu_torch/obs/tracer.py", "chip_smoke.py"} <= names
    sim = {f"gpuschedule_tpu_torch/{m}.py" for m in (
        "sim/__init__", "sim/job", "sim/jobset", "sim/trace", "sim/philly", "sim/metrics",
        "sim/overhead", "sim/engine", "obs/metrics", "obs/perfetto", "cluster/base",
        "cluster/tpu", "policies/__init__", "policies/base", "policies/preemptive",
        "policies/fifo", "policies/srtf", "policies/dlas", "policies/optimus",
        "policies/gandiva", "policies/themis", "cluster/gpu", "placement/__init__",
        "placement/schemes", "net/__init__", "net/fabric", "net/maxmin", "net/model",
        "faults/__init__", "faults/schedule", "faults/hazard", "faults/recovery", "analysis",
        "sim/ledger", "sim/snapshot", "worldspec", "obs/selfprof", "obs/analyze",
        "obs/history", "obs/compare", "obs/report", "obs/__init__", *COPIES)}
    assert sim <= names


# Modules that are the JAX package's with the package's name replaced:
# port module -> (the JAX package's file, top-level statements allowed to
# differ and why).  Docstrings aside, every other statement is the same.
COPIES = {
    "sim/pool": ("gpuschedule_tpu/sim/pool.py", {
        # a pool of a process with a CUDA context spawns its workers
        "import sys", "default_context", "WorkerPool"}),
    "obs/fleet": ("gpuschedule_tpu/obs/fleet.py", set()),
    "faults/sweep": ("gpuschedule_tpu/faults/sweep.py", set()),
    "net/sweep": ("gpuschedule_tpu/net/sweep.py", set()),
    "sim/whatif": ("gpuschedule_tpu/sim/whatif.py", set()),
    # the tools run as ``python -m``: no sys.path entry, so no ``os``; a
    # ``main`` differs in its flags' help text alone (history references
    # trimmed; whatif_bench's --speedup-floor names the JAX package's target)
    "tools/report_smoke": ("tools/report_smoke.py", {"import os"}),
    "tools/fault_sweep": ("tools/fault_sweep.py", {"import os", "main"}),
    "tools/net_sweep": ("tools/net_sweep.py", {"import os", "main"}),
    "tools/fault_chaos": ("tools/fault_chaos.py", {"import os"}),
    "tools/attrib_smoke": ("tools/attrib_smoke.py", {"import os"}),
    "tools/engine_bench": ("tools/engine_bench.py", {"import os", "main"}),
    "tools/whatif_bench": ("tools/whatif_bench.py", {"main"}),
}


def _statements(path: Path, rename: bool) -> dict:
    """A module's top-level statements by name (a definition's, an
    assignment's targets, an import's text), each as its AST dump with
    every docstring dropped; ``rename`` reads ``gpuschedule_tpu`` imports
    as the port's and drops ``sys.path`` edits."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)):
            first = node.body[0] if node.body else None
            if (isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                node.body = node.body[1:] or [ast.Pass()]
        if rename and isinstance(node, ast.ImportFrom) and node.module and (
                node.module.split(".")[0] == "gpuschedule_tpu"):
            node.module = "gpuschedule_tpu_torch" + node.module[len("gpuschedule_tpu"):]
    found = {}
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.ClassDef)):
            key = stmt.name
        elif isinstance(stmt, ast.Import):
            key = "import " + ", ".join(a.name for a in stmt.names)
        elif isinstance(stmt, ast.ImportFrom):
            key = f"from {stmt.module} import " + ", ".join(a.name for a in stmt.names)
        elif isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            key = ", ".join(ast.unparse(t) for t in targets)
        else:
            key = ast.unparse(stmt)
            if rename and key.startswith("sys.path.insert("):
                continue
        found[key] = ast.dump(stmt)
    return found


@pytest.mark.parametrize("module", sorted(COPIES))
def test_copy_is_the_jax_module_statement_for_statement(module):
    """The port's copy against the JAX package's module: the same
    top-level statements, each the same AST, docstrings aside, but for
    the differences COPIES names."""
    jax_file, allowed = COPIES[module]
    port = _statements(ROOT / "gpuschedule_tpu_torch" / f"{module}.py", rename=False)
    ref = _statements(ROOT / jax_file, rename=True)
    differ = {k for k in port.keys() | ref.keys() if port.get(k) != ref.get(k)}
    assert differ == allowed


def test_unported_options_raise(tmp_path):
    """pp, tp and sp take the JAX package's errors on a
    world of one rank (they run in tests/test_torch_ring*.py and
    tests/test_torch_tp*.py, over gloo ranks, the MoE models too), and a
    tp that does not divide the model raises; the trainer's ring
    and flash options raise the JAX trainer's errors, a CNN with an
    attention core raises the JAX ``build_model``'s, and a mesh must span
    the launcher's world."""
    with pytest.raises(SystemExit, match="not divisible by pp\\*sp\\*tp=2"):
        main(["train", "--model", "transformer-tiny", "--tp", "2", "--device", "cpu"])
    for kw in ({"sp": 2}, {"tp": 2}, {"pp": 2}):
        with pytest.raises(ValueError, match=r"ks \[1\] not divisible by sp\*tp\*pp=2"):
            profile_model("transformer-tiny", device="cpu", **kw)
        with pytest.raises(ValueError, match="exceeds the 1 available devices"):
            profile_model("transformer-tiny", ks=(2, 4), device="cpu", **kw)
    with pytest.raises(SystemExit, match=r"ks \[1\] not divisible by sp\*tp\*pp=2"):
        main(["profile", "--model", "transformer-tiny", "--pp", "2", "--device", "cpu",
              "--curves", str(tmp_path / "c.json")])
    with pytest.raises(SystemExit, match="exceeds the 1 available devices"):
        main(["profile", "--model", "transformer-tiny", "--tp", "2", "--ks", "2,4",
              "--device", "cpu", "--curves", str(tmp_path / "c.json")])
    for kw in ({"ring_attn": True}, {"ring_attn": True, "flash_attn": True}):
        with pytest.raises(ValueError, match="ring_attn requires seq_shard=True"):
            ShardedTrainer("transformer-tiny", device="cpu", **kw)
    with pytest.raises(ValueError, match="flash_attn keeps S per-device"):
        ShardedTrainer("transformer-tiny", flash_attn=True, seq_shard=True, device="cpu")
    with pytest.raises(SystemExit, match="world of 1 ranks"):
        main(["train", "--model", "transformer-tiny", "--devices", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="n_heads 4 of 'moe-tiny' not divisible by tp=8"):
        build_model("moe-tiny", tp=Tp(8, 0))
    with pytest.raises(ValueError, match="attn_fn applies to transformer LMs, not CNNs"):
        build_model("resnet-tiny", attn_fn=lambda q, k, v: q)
    with pytest.raises(ValueError, match="attn_fn applies to transformer LMs, not CNNs"):
        ShardedTrainer("resnet-tiny", flash_attn=True, device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        build_model("no-such-model")


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
def test_every_zoo_model_builds_and_takes_a_trainer(name):
    """All 14 zoo names build (on the meta device: no memory) and take a
    trainer on the CPU; the CNNs' batches are (images, labels) pairs."""
    with torch.device("meta"):
        model, cfg = build_model(name)
    assert cfg is MODEL_CONFIGS[name] and sum(p.numel() for p in model.parameters()) > 0
    tr = ShardedTrainer(name, batch_size=2, seq_len=16, device="cpu")
    assert tr.is_image == isinstance(cfg, CnnConfig)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    """Every import statement of the port and of chip_smoke.py, at any
    depth, names neither JAX nor the JAX package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name}:{node.lineno} imports {name}"


def test_port_imports_with_jax_blocked():
    """Import every port module in a fresh interpreter where importing JAX
    or the JAX package fails."""
    mods = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES if p.name not in ("chip_smoke.py", "__main__.py")
    ]
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_kernel_input_checks():
    """What the CUDA wrappers check before a launch (the checks themselves
    read no device, so they run here on CPU tensors)."""
    from gpuschedule_tpu_torch.ops.flash_attention import _check_cuda, _check_cuda_block

    q = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    rows = torch.zeros(2, 8)
    _check_cuda((q, q, q, q), (rows, rows))
    with pytest.raises(TypeError, match="share one dtype"):
        _check_cuda((q, q.float(), q))
    with pytest.raises(TypeError, match="not supported"):
        _check_cuda((q.half(), q.half(), q.half()))
    with pytest.raises(ValueError, match="contiguous"):
        _check_cuda((q, q.transpose(1, 2), q))
    with pytest.raises(ValueError, match="contiguous"):
        _check_cuda((q, q, q), (rows.t(),))
    _check_cuda_block(None)
    _check_cuda_block(64)
    with pytest.raises(ValueError, match="64x64"):
        _check_cuda_block(128)


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    """A compiler that fails makes the build raise with its output; no
    library is left behind to load.  The stand-in compiler is the Python
    interpreter, which exits non-zero on nvcc's flags."""
    from gpuschedule_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: sys.executable)
    with pytest.raises(RuntimeError, match="CUDA kernel build failed"):
        _build.build_all()
    assert not list(tmp_path.glob("*.so"))


def test_alignment_check_and_compiled_tile():
    """The tensor-core kernels copy 16-byte vectors, so the CUDA path
    refuses a tensor that starts off a 16-byte boundary before any launch
    (the check reads only ``data_ptr``, so it runs here on CPU views).  It
    is part of ``_check_cuda``, which every wrapper's CUDA path runs, dq's
    included.  The plain path on CPU tensors is unaffected: a misaligned
    view gives what an aligned copy gives.  And the CUDA path still refuses
    a block other than the compiled tile."""
    from gpuschedule_tpu_torch.ops.flash_attention import (
        TILE, _check_aligned, _check_cuda, _check_cuda_block, attention_delta, flash_bwd_dkdv,
        flash_bwd_dq, flash_fwd,
    )

    n = 1 * 40 * 2 * 32
    buf = torch.randn(n + 8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    q = buf[1:n + 1].view(1, 40, 2, 32)  # 2 bytes past an aligned start
    assert q.data_ptr() % 16 == 2 and q.is_contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        _check_aligned((q, q, q))
    _check_aligned((buf[8:].view(1, 40, 2, 32),))  # 16 bytes in: fine

    qa = q.clone()
    assert qa.data_ptr() % 16 == 0
    rows = torch.zeros(2, 40)
    with pytest.raises(ValueError, match="16-byte"):
        _check_cuda((qa, qa, qa, q), (rows, rows))  # a misaligned dO
    out, lse = flash_fwd(q, q, q, causal=True)
    out_a, lse_a = flash_fwd(qa, qa, qa, causal=True)
    assert torch.equal(out, out_a) and torch.equal(lse, lse_a)
    delta = attention_delta(out, q)
    dk, dv = flash_bwd_dkdv(q, q, q, q, lse, delta, causal=True)
    dk_a, dv_a = flash_bwd_dkdv(qa, qa, qa, qa, lse, delta, causal=True)
    assert torch.equal(dk, dk_a) and torch.equal(dv, dv_a)
    assert torch.equal(flash_bwd_dq(q, q, q, q, lse, delta, causal=True),
                       flash_bwd_dq(qa, qa, qa, qa, lse, delta, causal=True))

    _check_cuda_block(TILE)
    for block in (32, 2 * TILE):
        with pytest.raises(ValueError, match=f"{TILE}x{TILE}"):
            _check_cuda_block(block)
