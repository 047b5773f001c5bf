"""Synthetic token batches — the port's own copy of the JAX package's
``synthetic_lm_batches``.

Pure numpy, keyed by ``(seed, index)``, so both packages draw identical
tokens from the same seed: the parity tests feed one stream to both.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["synthetic_lm_batches"]


def _check_host_shard(host_shard) -> "tuple[int, int]":
    if host_shard is None:
        return 0, 1
    idx, count = host_shard
    if count < 1 or not (0 <= idx < count):
        raise ValueError(f"host_shard must be (index, count), 0 <= index < count; got {host_shard}")
    return int(idx), int(count)


def synthetic_lm_batches(
    *,
    batch_size: int,
    seq_len: int,
    vocab: int,
    num_batches: int,
    seed: int = 0,
    start: int = 0,
    host_shard: "tuple[int, int] | None" = None,
) -> Iterator[np.ndarray]:
    """Deterministic random (batch_size, seq_len) int32 token batches.

    Batch i is keyed by (seed, i), so ``start`` resumes the stream at any
    position in O(1).  ``host_shard=(index, count)`` yields every
    ``count``-th global position from ``index``."""
    idx, count = _check_host_shard(host_shard)
    first = start + ((idx - start) % count)  # first host-owned pos >= start
    for i in range(first, num_batches, count):
        yield np.random.default_rng((seed, i)).integers(
            0, vocab, size=(batch_size, seq_len), dtype=np.int32
        )
