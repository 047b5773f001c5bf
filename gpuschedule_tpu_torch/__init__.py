"""gpuschedule_tpu_torch — the PyTorch/CUDA port of gpuschedule_tpu.

The unit of measured work is the same as in the JAX package: one optimizer
step of a zoo model (a ``TransformerLM``, dense or MoE, or a ``ResNet``).
This package runs it on one NVIDIA H100, with
hand-written CUDA kernels (``ops/csrc/``) in place of the Pallas
flash-attention kernels.  It imports ``torch`` only: nothing of JAX and
nothing of ``gpuschedule_tpu``, of which it keeps its own copies.

Layering:
    models/     model configs (own copy), the transformer LM and the ResNet
    ops/        dense oracle, flash attention: CUDA kernels + plain versions
    parallel/   mesh, sp rings (dense and flash) and gather, tp, optimizer, the
                train step and the pipeline
    data/       synthetic token batches (own copy, numpy)
    profiler/   step and callable timing on the card, goodput curves
    sim/        the trace-replay simulator (host code): engine, jobs, traces, metrics
    cluster/    the flat pool and the TPU slice allocator the replay runs on
    policies/   FIFO, SRTF, Tiresias-DLAS, Optimus (online: profiles on the card)
    obs/        the span tracer and the metrics registry
    convert.py  flax parameter trees -> this package's state_dict
    cli.py      ``python -m gpuschedule_tpu_torch {run,gen-trace,train,profile} ...``
    entry.py    the driver's entry points: the flagship's forward, the dryrun

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``;
see :func:`resolve_device`.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: ``cuda`` when CUDA is available, else a
    ``RuntimeError`` — a run that asked for no device never carries on
    quietly on the CPU.  An explicit ``"cpu"`` (what the tests pass) or
    ``"cuda[:i]"`` is taken as given; asking for CUDA where there is none
    raises too."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
