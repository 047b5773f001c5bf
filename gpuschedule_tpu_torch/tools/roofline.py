"""Analytic roofline of the flash-attention CUDA kernels on a card.

Counterpart of ``tools/roofline.py``.  Two bounds live here:

- the *function's* bound (:func:`attention_cost`, :func:`bound`): the
  FLOPs of the (row, key) pairs a causal mask keeps and the bytes of each
  input read once and each output written once, over the card's peaks:
  the least time any kernel could take for the same work, the ``bound_ms``
  that ``chip_smoke.py`` and PERF.md hold each kernel to
  (:func:`probe_cost` does the same for the overhead probe's kernels);
- the *executed* roofline (:func:`analyze`): what the three kernels of
  ``ops/csrc/flash_attention.cu`` compute at their compiled 64 x 64 tile,
  the whole tiles on and below the causal diagonal with the s and dp tiles
  recomputed in the backward, and what each thread block streams through
  its ``cp.async`` ring.

On the card a K/V (or q/dO) tile read again by the next block mostly comes
from the 50 MB L2, not from HBM, so the streamed bytes are reported as
tile traffic beside the function's HBM bytes and bound no time.
:func:`fit_overhead` attributes the gap between a measured fwd+bwd time and
the executed roofline to a cost per visited tile, as the JAX tool
attributes it to a cost per grid step.  Pure arithmetic, no card needed:

    python -m gpuschedule_tpu_torch.tools.roofline                # analysis at 2,4096,8,128
    python -m gpuschedule_tpu_torch.tools.roofline --fit MS       # + the overhead fit
    python -m gpuschedule_tpu_torch.tools.roofline --shape 2,4096,8,32 --card h100-sxm
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from gpuschedule_tpu_torch.cluster.cards import CARDS
from gpuschedule_tpu_torch.ops.flash_attention import HEAD_DIMS, TILE

BF16 = 2
F32 = 4
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")  # the wrappers' counter names
# matmuls a kernel runs per visited tile: K1 s and p·V; K2 s, dp and ds·K;
# K3 s, dp, pᵀ·dO and dsᵀ·q (the backward recomputes s and dp)
MATMULS = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkdv": 4}


def attention_cost(b, s, h, d, causal, esize, kernel, out_esize=None):
    """(flops, bytes) the kernel's function needs on these inputs: each
    input read once (``esize`` bytes an element), each output written once
    (``out_esize``, default ``esize``); causal counts the S(S+1)/2 (row,
    key) pairs that are not masked.  ``kernel`` is a counter name; the f32
    forms (``*_f32``) cost what their kernel does."""
    kernel = kernel.removesuffix("_f32")
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    n = b * s * h * d * esize
    n_out = b * s * h * d * (out_esize or esize)
    rows = b * h * s * 4
    if kernel == "flash_fwd":      # QK^T, PV; reads q k v, writes o and lse
        return 4 * d * pairs, 3 * n + n_out + rows
    if kernel == "flash_bwd_dq":   # QK^T, dO V^T, ds K; reads q k v dO lse delta, writes dq
        return 6 * d * pairs, 4 * n + 2 * rows + n_out
    # QK^T, dO V^T, p^T dO, ds^T q; reads q k v dO lse delta, writes dk dv
    return 8 * d * pairs, 4 * n + 2 * rows + 2 * n_out


def bound(flops, nbytes, peaks):
    """(ms, what bounds it): the least time the card of ``peaks`` (a
    ``CARDS`` entry) could take for these bf16 operations and bytes."""
    t_ops, t_bytes = flops / peaks["bf16_flops"], nbytes / peaks["bytes_per_s"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def probe_cost(n, block, kernel):
    """(flops, bytes) of a probe kernel's function over n (8, block) bf16
    tiles: x read once, out written once; K5b forms 8 x block outputs of 8
    products each per tile."""
    nbytes = 2 * (n * 8 * block * 2)
    return (0 if kernel == "probe_copy" else 2 * 8 * 8 * block * n), nbytes


def visited_tiles(s_pad: int, bq: int, bk: int, causal: bool) -> int:
    """Tiles the kernels actually compute (the pl.when skip rule)."""
    nq, nk = s_pad // bq, s_pad // bk
    if not causal:
        return nq * nk
    return sum(
        sum(1 for kb in range(nk) if kb * bk <= qi * bq + bq - 1)
        for qi in range(nq)
    )


def analyze(b: int, s: int, h: int, d: int, *, causal: bool = True, card: str = "h100-sxm",
            out_esize: int = BF16) -> dict:
    """The executed roofline of K1-K3 on bf16 (B, S, H, D) inputs, outputs
    of ``out_esize`` bytes an element (4: the f32 forms), on ``card``.

    The kernels' rules: one block a 64-row tile of q (K1, K2) or of k (K3)
    for each (b, h); K1 and K2 stop at the diagonal tile (``kend = min(S,
    q0 + BQ)``), K3 starts there (``qstart = k0``), so each visits the
    :func:`visited_tiles` of the padded S at 64 x 64, every tile whole.
    D is not padded.  Per visited tile each kernel runs :data:`MATMULS`
    products of 64 x 64 x D, and its ring streams the other operand's two
    tiles (K1, K2: K and V; K3: q and dO, with their lse and delta rows),
    after its own tiles once a block and before its outputs."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one the kernels are built for: {HEAD_DIMS}")
    peaks = CARDS[card]
    nq = -(-s // TILE)
    s_pad = nq * TILE
    bh = b * h
    v = visited_tiles(s_pad, TILE, TILE, causal)
    tile = TILE * d * BF16            # a 64 x D bf16 tile of q, k, v or dO
    out = TILE * d * out_esize        # a 64 x D tile of an output
    rows = TILE * F32                 # 64 f32 rows of lse or delta
    traffic = {
        "flash_fwd": bh * (nq * (tile + out + rows) + v * 2 * tile),
        "flash_bwd_dq": bh * (nq * (2 * tile + 2 * rows + out) + v * 2 * tile),
        "flash_bwd_dkdv": bh * (nq * (2 * tile + 2 * out) + v * (2 * tile + 2 * rows)),
    }
    out_size = None if out_esize == BF16 else out_esize
    bounds, executed, function = {}, {}, {}
    total_ms = 0.0
    for k in KERNELS:
        flops = v * MATMULS[k] * 2 * TILE * TILE * d * bh
        f_flops, f_bytes = attention_cost(b, s, h, d, causal, BF16, k, out_size)
        t_c = flops / peaks["bf16_flops"] * 1e3
        t_m = f_bytes / peaks["bytes_per_s"] * 1e3
        executed[k] = flops
        fn_ms, fn_by = bound(f_flops, f_bytes, peaks)
        function[k] = {"gflops": f_flops / 1e9, "hbm_mb": f_bytes / 1e6, "bound_ms": fn_ms,
                       "bound_by": fn_by}
        bounds[k] = {"t_compute_ms": t_c, "t_hbm_ms": t_m,
                     "bound": "compute" if t_c >= t_m else "hbm",
                     "intensity_flop_per_byte": flops / f_bytes,
                     "tile_traffic_mb": traffic[k] / 1e6,
                     "tile_traffic_over_hbm": traffic[k] / f_bytes}
        total_ms += max(t_c, t_m)
    f_total = sum(attention_cost(b, s, h, d, causal, BF16, k, out_size)[0] for k in KERNELS)
    useful_fwd = 2 * 2 * b * h * s * s * d / (2 if causal else 1)
    return {
        "shape": f"b{b}s{s}h{h}d{d}",
        "card": card,
        "blocks": (TILE, TILE),
        "visited_tiles": v,
        "total_tiles": nq * nq,
        "tile_visits": {k: bh * v for k in KERNELS},
        "executed_gflops": {k: f / 1e9 for k, f in executed.items()},
        "executed_over_function_flops": sum(executed.values()) / f_total,
        "function": function,
        "bounds_ms": bounds,
        "roofline_fwdbwd_ms": total_ms,
        "roofline_fwd_ms": max(bounds["flash_fwd"]["t_compute_ms"],
                               bounds["flash_fwd"]["t_hbm_ms"]),
        "function_fwdbwd_ms": sum(function[k]["bound_ms"] for k in KERNELS),
        "useful_fwdbwd_gflops": 3.5 * useful_fwd / 1e9,
        "roofline_useful_tflops": 3.5 * useful_fwd / (total_ms / 1e3) / 1e12,
    }


def fit_overhead(measured_fwdbwd_ms: float, a: dict) -> dict:
    """Attribute measured - roofline to a cost per visited tile."""
    tiles = sum(a["tile_visits"].values())
    gap_ms = measured_fwdbwd_ms - a["roofline_fwdbwd_ms"]
    return {
        "measured_fwdbwd_ms": measured_fwdbwd_ms,
        "roofline_fwdbwd_ms": a["roofline_fwdbwd_ms"],
        "gap_ms": gap_ms,
        "total_tile_visits": tiles,
        "implied_us_per_tile": gap_ms * 1e3 / tiles,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpuschedule_tpu_torch.tools.roofline")
    p.add_argument("--fit", type=float, default=None,
                   help="measured fwd+bwd ms to fit a cost per visited tile")
    p.add_argument("--shape", default="2,4096,8,128")
    p.add_argument("--blocks", default=f"{TILE},{TILE}",
                   help=f"the kernels are compiled at one tile: only {TILE},{TILE}")
    p.add_argument("--card", default="h100-sxm", choices=sorted(CARDS))
    args = p.parse_args(argv)
    b, s, h, d = (int(x) for x in args.shape.split(","))
    if tuple(int(x) for x in args.blocks.split(",")) != (TILE, TILE):
        p.error(f"the CUDA kernels tile at {TILE}x{TILE}; got --blocks {args.blocks}")
    a = analyze(b, s, h, d, card=args.card)
    print(json.dumps(a, indent=2))
    if args.fit is not None:
        print(json.dumps(fit_overhead(args.fit, a), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
