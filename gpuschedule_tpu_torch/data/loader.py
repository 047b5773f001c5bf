"""Token batches and their way onto the device: the port's own copy of the
JAX package's ``data/loader.py``.

- :class:`TokenFileDataset`: a flat binary token file (any integer dtype),
  memory-mapped and cut into fixed (batch, seq) blocks whose order each
  epoch shuffles by seed.  Pure numpy, so both packages yield the same
  int32 batches from the same file and seed.
- :func:`synthetic_lm_batches`: the zero-IO stream with the same iterator
  contract, keyed by ``(seed, index)``.
- :class:`BatchSharding`: this rank's share of a global batch and the
  device it lands on, the port's counterpart of the JAX trainer's
  ``batch_sharding`` (``ShardedTrainer.batch_sharding``; its
  ``to_device`` cuts batches with it too).
- :func:`prefetch_to_device`: keeps ``size`` batches in flight ahead of
  the consumer.  On a card each batch is cut to the rank's share on the
  host, pinned and copied on a stream of its own, so the copies overlap
  the device's current step.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

__all__ = ["BatchSharding", "TokenFileDataset", "prefetch_to_device", "synthetic_lm_batches"]


class TokenFileDataset:
    """Fixed-shape LM batches from a flat binary token file.

    ``path`` holds tokens as a 1-D array of ``dtype``; blocks of
    ``batch * seq_len`` consecutive tokens become one (batch, seq_len)
    int32 batch.  Block order shuffles per (epoch, seed); the tail that
    does not fill a block is dropped (static shapes: one captured step)."""

    def __init__(
        self,
        path: str | Path,
        *,
        batch_size: int,
        seq_len: int,
        dtype: str = "uint16",
        seed: int = 0,
    ):
        self.path = Path(path)
        self.batch_size = int(batch_size)
        self.seq_len = int(seq_len)
        if self.batch_size < 1 or self.seq_len < 1:
            raise ValueError("batch_size and seq_len must be >= 1")
        self.seed = seed
        self._tokens = np.memmap(self.path, dtype=np.dtype(dtype), mode="r")
        self.block = self.batch_size * self.seq_len
        self.num_batches = len(self._tokens) // self.block
        if self.num_batches == 0:
            raise ValueError(
                f"{self.path} holds {len(self._tokens)} tokens; "
                f"one batch needs {self.block}"
            )

    def __len__(self) -> int:
        return self.num_batches

    def batches(
        self, *, epoch: int = 0, start: int = 0,
        host_shard: "tuple[int, int] | None" = None,
    ) -> Iterator[np.ndarray]:
        """Yield every batch of the epoch once, in the order of the
        (seed, epoch) permutation.

        ``start`` skips that many batches of the epoch in O(1): resume
        jumps to its position.  ``host_shard=(index, count)`` yields only
        every ``count``-th batch from ``index`` of the same permutation, so
        the hosts' streams partition the epoch; ``start`` stays in global
        stream positions."""
        order = np.random.default_rng((self.seed, epoch)).permutation(self.num_batches)
        idx, count = _check_host_shard(host_shard)
        first = start + ((idx - start) % count)  # first host-owned pos >= start
        for pos in range(first, self.num_batches, count):
            off = int(order[pos]) * self.block
            chunk = np.asarray(self._tokens[off:off + self.block])
            yield chunk.astype(np.int32).reshape(self.batch_size, self.seq_len)

    @staticmethod
    def write(tokens, path: str | Path, *, dtype: str = "uint16") -> Path:
        """Write a token array as a dataset file.  Refuses token ids outside
        the dtype's range, which ``astype`` would wrap silently."""
        arr = np.asarray(tokens)
        info = np.iinfo(np.dtype(dtype))
        if arr.size and (arr.min() < info.min or arr.max() > info.max):
            raise ValueError(
                f"token ids span [{arr.min()}, {arr.max()}], outside "
                f"{dtype}'s [{info.min}, {info.max}]; pick a wider dtype"
            )
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        arr.astype(np.dtype(dtype)).tofile(path)
        return path


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


@dataclass(frozen=True)
class BatchSharding:
    """Where a global batch goes on this rank: rows ``[row0, row0 + rows)``
    and, of a token batch, positions ``[seq0, seq0 + seq_len]`` (the chunk
    and one token past it, the label of the chunk's last position; the
    last chunk has none past it), on ``device``.  With ``blocks`` > 1 the
    batch's rows are that many equal blocks (a pipeline's microbatches)
    and the rank takes rows ``[row0, row0 + rows)`` of each, block after
    block."""

    device: torch.device
    row0: int
    rows: int
    seq0: int
    seq_len: int
    blocks: int = 1

    def _rows(self, x: np.ndarray) -> np.ndarray:
        blocked = x.reshape(self.blocks, -1, *x.shape[1:])
        return blocked[:, self.row0:self.row0 + self.rows].reshape(-1, *x.shape[1:])

    def host_share(self, batch):
        """This rank's share of ``batch`` as new, writable, C-ordered numpy
        arrays: a token batch as int64, an ``(images, labels)`` pair as
        (float32, int64)."""
        if isinstance(batch, (tuple, list)):
            images, labels = (self._rows(np.asarray(x)) for x in batch)
            return (np.array(images, dtype=np.float32, order="C"),
                    np.array(labels, dtype=np.int64, order="C"))
        cols = slice(self.seq0, self.seq0 + self.seq_len + 1)
        return np.array(self._rows(np.asarray(batch))[:, cols], dtype=np.int64, order="C")

    def to_device(self, batch):
        """``host_share`` as tensors on the device, copied synchronously."""
        share = self.host_share(batch)
        if isinstance(share, tuple):
            return tuple(torch.from_numpy(x).to(self.device) for x in share)
        return torch.from_numpy(share).to(self.device)


def prefetch_to_device(iterator, *, sharding: BatchSharding, size: int = 2):
    """Keep ``size`` device-placed batches in flight ahead of the consumer.

    ``sharding`` (the trainer's ``batch_sharding``) cuts each global batch
    to this rank's share and names the device.  On a card each share is
    pinned and copied with
    ``non_blocking=True`` on a copy stream, one CUDA event a batch.  A
    batch is handed over only after the consumer's current stream is made
    to wait on its event (``wait_event``, no host sync), so work the
    consumer queues next (the captured step's copy into its static
    buffers) reads the whole batch; and the device batch is marked used on
    that stream (``record_stream``), so the caching allocator does not give
    its memory to a later copy before the consumer's work on it is done.
    The pinned buffer stays in the queue until its batch is handed over;
    after that PyTorch's pinned allocator holds the block until the event
    of the copy that read it.  On the CPU it places with a plain ``.to``."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    device = sharding.device
    queue: collections.deque = collections.deque()

    if device.type != "cuda":
        def put(batch):
            return sharding.to_device(batch)

        def take(placed):
            return placed
    else:
        copy_stream = torch.cuda.Stream(device)

        def put(batch):
            share = sharding.host_share(batch)
            pinned = [torch.from_numpy(x).pin_memory()
                      for x in (share if isinstance(share, tuple) else (share,))]
            with torch.cuda.stream(copy_stream):
                placed = [h.to(device, non_blocking=True) for h in pinned]
                event = torch.cuda.Event()
                event.record(copy_stream)
            return placed, pinned, event, isinstance(share, tuple)

        def take(entry):
            placed, _pinned, event, pair = entry
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for t in placed:
                t.record_stream(consumer)
            return tuple(placed) if pair else placed[0]

    for batch in iterator:
        queue.append(put(batch))
        if len(queue) == size:
            yield take(queue.popleft())
    while queue:
        yield take(queue.popleft())
