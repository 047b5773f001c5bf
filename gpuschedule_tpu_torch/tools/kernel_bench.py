"""Flash-attention kernel speed on the card, beside dense attention and SDPA.

Counterpart of ``tools/kernel_bench.py``: times the flash kernels (forward,
and forward plus backward) against the dense oracle at the same shape and
dtype, one JSON line a case with the JAX tool's keys (``case``, ``ms``,
``tflops``) and case names.  This splits a train step's time: a whole
model's step (``python -m gpuschedule_tpu_torch.bench``) mixes the
kernels with the embedding and head products and every elementwise pass.

    python -m gpuschedule_tpu_torch.tools.kernel_bench                # on the card
    python -m gpuschedule_tpu_torch.tools.kernel_bench --device cpu   # plain versions

The JAX tool sweeps eight Pallas block pairs.  The CUDA kernels are
compiled at one 64 x 64 tile (``ops/flash_attention.py``,
``_check_cuda_block``), so here each shape has one flash pair, ``bq64
bk64``, and two rows the JAX tool has not: ``sdpa fwd`` and ``sdpa
fwd+bwd`` (``F.scaled_dot_product_attention``, causal), a yardstick that
nothing in the port calls.  Each row also carries

- ``device_ms``: device time per call, the sum of the device records of a
  ``torch.profiler`` window of the calls (``profiler.harness.device_window``);
- ``bound_ms``: the least time the card could take for the row's function,
  ``roofline.bound`` of ``roofline.attention_cost``, summed over K1 (a
  forward) or K1-K3 (forward and backward), the same for every row of one
  function;
- ``launches``: K1-K3's launches per call by the wrappers' counters, and
  ``route``: ``cuda`` (our kernels), ``plain`` (their plain versions, off
  the card), ``dense`` or ``library``.

``ms`` is CUDA events around back-to-back calls
(``profiler.time_callable``, the JAX tool's harness timing), the host clock
off the card.  The first line names the device and, on the card, its name
and power limit as ``nvidia-smi`` prints them.  The default shapes are the
JAX tool's: transformer-long's attention (2, 4096, 8, 32) and a wider head
(2, 4096, 8, 128), bf16.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gpuschedule_tpu_torch import resolve_device
from gpuschedule_tpu_torch.cluster.cards import CARDS, detect_card, nvidia_smi_line
from gpuschedule_tpu_torch.ops.flash_attention import LAUNCHES, TILE, flash_attention
from gpuschedule_tpu_torch.ops.reference import dense_attention
from gpuschedule_tpu_torch.profiler.harness import device_window, time_callable
from gpuschedule_tpu_torch.tools.roofline import attention_cost, bound

SHAPES = ((2, 4096, 8, 32), (2, 4096, 8, 128))
ITERS = 10
FWD = ("flash_fwd",)
FWD_BWD = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")


def attn_flops(b, s, h, d, causal=True):
    """Useful FLOPs of one attention forward: qk^T + pv matmuls."""
    full = 2 * 2 * b * h * s * s * d
    return full / 2 if causal else full


def inputs(b, s, h, d, dtype, device, seed: int = 0):
    """q, k, v: (B, S, H, D) normals in ``dtype`` from a generator seeded
    with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((b, s, h, d), generator=gen, device=device).to(dtype)
                 for _ in range(3))


def _sdpa(q, k, v):
    """SDPA on (B, S, H, D): its (B, H, S, D) layout and back."""
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), is_causal=True)
    return out.transpose(1, 2)


def _flash(q, k, v):
    return flash_attention(q, k, v, causal=True)


def _dense(q, k, v):
    return dense_attention(q, k, v, causal=True)


def _fwd_bwd(attn: Callable, q, k, v):
    """A call of ``attn``'s forward and backward: the gradients of
    ``sum(out²)`` (f32) with respect to q, k and v, as the JAX tool's loss."""
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

    def call():
        out = attn(*leaves)
        return torch.autograd.grad((out.float() ** 2).sum(), leaves)

    return call


def cases(q, k, v) -> Dict[str, Tuple[Callable, float, Tuple[str, ...], str]]:
    """{case name: (call, FLOP multiple of a forward, K1-K3 counters the
    function's bound sums, route)} at q, k, v's shape; flash is on the card
    our kernels and off it their plain versions."""
    flash = "cuda" if q.is_cuda else "plain"
    pair = f"bq{TILE} bk{TILE}"
    return {
        "dense fwd": (lambda: _dense(q, k, v), 1, FWD, "dense"),
        "dense fwd+bwd": (_fwd_bwd(_dense, q, k, v), 3.5, FWD_BWD, "dense"),
        f"flash fwd {pair}": (lambda: _flash(q, k, v), 1, FWD, flash),
        f"flash fwd+bwd {pair}": (_fwd_bwd(_flash, q, k, v), 3.5, FWD_BWD, flash),
        "sdpa fwd": (lambda: _sdpa(q, k, v), 1, FWD, "library"),
        "sdpa fwd+bwd": (_fwd_bwd(_sdpa, q, k, v), 3.5, FWD_BWD, "library"),
    }


def _function_bound_ms(b, s, h, d, dtype, kernels, peaks) -> Optional[float]:
    """The least time for the row's function on the card of ``peaks`` (bf16
    only: the peaks are the tensor cores' bf16 rates; None without peaks)."""
    if dtype != torch.bfloat16 or peaks is None:
        return None
    return sum(bound(*attention_cost(b, s, h, d, True, 2, k), peaks)[0] for k in kernels)


def device_ms_per_call(fn, iters: int = ITERS) -> Tuple[float, int]:
    """(device ms per call, windows lost before it) from one profiler window
    of ``iters`` calls on the card."""
    win = device_window(fn, iters, what="kernel_bench")
    return sum(r.us for r in win.device) / iters / 1e3, win.lost


def run(b, s, h, d, dtype=torch.bfloat16, device=None, *, iters: int = ITERS,
        warmup: int = 2) -> List[dict]:
    """Time every case at (b, s, h, d) in ``dtype`` on ``device`` (the card
    unless ``"cpu"``): one JSON line a case, and the rows returned.  The
    bounds are the card's (``cluster.cards``; off the card the H100's, the
    port's card)."""
    dev = resolve_device(device)
    card = detect_card(torch.cuda.get_device_name(dev)) if dev.type == "cuda" else "h100-sxm"
    peaks = CARDS.get(card)
    q, k, v = inputs(b, s, h, d, dtype, dev)
    shape = f"b{b}s{s}h{h}d{d} {str(dtype).removeprefix('torch.')}"
    fl = attn_flops(b, s, h, d)
    rows = []
    for name, (call, mult, kernels, route) in cases(q, k, v).items():
        before = dict(LAUNCHES)
        sec = time_callable(call, iters=iters, warmup=warmup, device=dev)
        calls = iters + warmup
        launches = {n: (LAUNCHES[n] - before[n]) / calls for n in FWD_BWD}
        dev_ms, lost = device_ms_per_call(call, iters) if dev.type == "cuda" else (None, 0)
        row = {"case": f"{shape} {name}", "ms": sec * 1e3, "tflops": mult * fl / sec / 1e12,
               "device_ms": dev_ms,
               "bound_ms": _function_bound_ms(b, s, h, d, dtype, kernels, peaks),
               "launches": launches, "route": route, "lost_windows": lost}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def device_line(dev: torch.device) -> dict:
    """The first line of the port's tools: the backend, the device's name
    and, on the card, its name and power limit from ``nvidia-smi``."""
    if dev.type != "cuda":
        return {"backend": "cpu", "device": "cpu", "card": None}
    return {"backend": "cuda", "device": torch.cuda.get_device_name(dev),
            "card": nvidia_smi_line()}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpuschedule_tpu_torch.tools.kernel_bench")
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain PyTorch versions; default: the card")
    p.add_argument("--shape", action="append", default=None,
                   help="B,S,H,D (repeatable); default: the JAX tool's two shapes")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    shapes = [tuple(int(x) for x in s.split(",")) for s in args.shape] if args.shape else SHAPES
    print(json.dumps(device_line(dev)), flush=True)
    for shape in shapes:
        run(*shape, torch.bfloat16, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
