"""The port's input pipeline (``gpuschedule_tpu_torch/data/loader.py``)
against the JAX package's on the CPU.

``TokenFileDataset`` is numpy on both sides, so the same file and seed must
give equal int32 batches (exact), the two ``write``s byte-identical files,
and both the same errors.  ``prefetch_to_device`` places on the CPU here
with a plain ``.to``: the order, each rank's share (``BatchSharding``, the
trainer's cut) and the size check are what can be held off the card; its
pinned copies on a copy stream run in ``chip_smoke.py`` phase 13.
"""

import re

import numpy as np
import pytest
import torch

from gpuschedule_tpu.data import TokenFileDataset as JaxDataset
from gpuschedule_tpu_torch.data import (
    BatchSharding,
    TokenFileDataset,
    prefetch_to_device,
    synthetic_lm_batches,
)
from gpuschedule_tpu_torch.parallel import ShardedTrainer

CPU = torch.device("cpu")
WHOLE = BatchSharding(CPU, 0, 2, 0, 8)  # the whole of a (2, 8) batch


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the tiny CPU steps here: the driver runs six
    test workers on the box's cores, where more threads a step only wait
    on each other.  Restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def corpus(tmp_path):
    """12 batches of (2, 8) uint16 tokens, one partial block past them."""
    tokens = np.random.default_rng(7).integers(0, 8192, size=12 * 16 + 5)
    return TokenFileDataset.write(tokens, tmp_path / "corpus.bin")


@pytest.mark.parametrize("kw", [
    {}, {"epoch": 1}, {"start": 5}, {"epoch": 2, "start": 11},
    {"host_shard": (0, 2)}, {"host_shard": (1, 3), "epoch": 1},
    {"host_shard": (0, 2), "start": 3}, {"host_shard": (1, 2), "start": 3},
], ids=["epoch0", "epoch1", "start5", "epoch2-start11", "shard0of2", "shard1of3-epoch1",
        "shard0of2-start3", "shard1of2-start3"])
def test_batches_equal_jax(corpus, kw):
    """Exact: the same file, seed and arguments give the same int32 batches."""
    ours = list(TokenFileDataset(corpus, batch_size=2, seq_len=8, seed=3).batches(**kw))
    ref = list(JaxDataset(corpus, batch_size=2, seq_len=8, seed=3).batches(**kw))
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.int32 and a.shape == (2, 8)
        np.testing.assert_array_equal(a, b)


def test_len_and_epochs_reshuffle(corpus):
    ds = TokenFileDataset(corpus, batch_size=2, seq_len=8, seed=3)
    assert len(ds) == len(JaxDataset(corpus, batch_size=2, seq_len=8, seed=3)) == 12
    e0, e1 = ([b.tobytes() for b in ds.batches(epoch=e)] for e in (0, 1))
    assert e0 != e1 and sorted(e0) == sorted(e1)


@pytest.mark.parametrize("dtype", ["uint16", "int32", "uint32"])
def test_write_is_byte_identical_to_jax(tmp_path, dtype):
    tokens = np.random.default_rng(1).integers(0, 60_000, size=999)
    ours = TokenFileDataset.write(tokens, tmp_path / "a" / "ours.bin", dtype=dtype)
    ref = JaxDataset.write(tokens, tmp_path / "b" / "ref.bin", dtype=dtype)
    assert ours.read_bytes() == ref.read_bytes()


def _error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["too-small", "overflow", "negative", "bad-shape",
                                  "bad-shard"])
def test_errors_match_jax(tmp_path, case):
    """The same ValueError, word for word (the file's path aside)."""
    def make(cls):
        path = tmp_path / cls.__module__.split(".")[0] / "t.bin"
        if case == "too-small":
            p = cls.write(np.arange(10), path)
            return lambda: cls(p, batch_size=4, seq_len=16)
        if case == "overflow":
            return lambda: cls.write(np.array([0, 70_000]), path)
        if case == "negative":
            return lambda: cls.write(np.array([-1, 3]), path)
        p = cls.write(np.arange(64), path)
        if case == "bad-shape":
            return lambda: cls(p, batch_size=0, seq_len=16)
        return lambda: list(cls(p, batch_size=2, seq_len=8).batches(host_shard=(2, 2)))

    ours, ref = _error(make(TokenFileDataset)), _error(make(JaxDataset))
    strip = lambda s: re.sub(r"\S*t\.bin", "<file>", s)  # noqa: E731
    assert strip(ours) == strip(ref)


def test_wider_dtype_round_trip(tmp_path):
    p = TokenFileDataset.write(np.array([0, 70_000]), tmp_path / "x.bin", dtype="uint32")
    ds = TokenFileDataset(p, batch_size=1, seq_len=2, dtype="uint32")
    np.testing.assert_array_equal(next(ds.batches()), [[0, 70_000]])


@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_keeps_order_on_the_cpu(size):
    src = list(synthetic_lm_batches(batch_size=2, seq_len=8, vocab=50, num_batches=4))
    out = list(prefetch_to_device(iter(src), size=size, sharding=WHOLE))
    assert len(out) == 4
    for a, b in zip(out, src):
        assert a.device == CPU and a.dtype == torch.int64
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("size", [0, -1])
def test_prefetch_raises_on_size_below_one(size):
    with pytest.raises(ValueError, match=f"prefetch size must be >= 1, got {size}"):
        next(prefetch_to_device(iter([np.zeros((1, 2))]), size=size,
                                sharding=WHOLE))


@pytest.mark.parametrize("row0,rows,seq0,seq_len", [
    (0, 4, 0, 16), (2, 2, 0, 8), (0, 2, 8, 8), (2, 2, 8, 8), (1, 1, 4, 4),
])
def test_prefetch_yields_each_ranks_share(row0, rows, seq0, seq_len):
    """A rank's rows and chunk, and one token past the chunk (its last
    label) where there is one; an (images, labels) pair by rows."""
    tokens = np.arange(4 * 16, dtype=np.int32).reshape(4, 16)
    cut = BatchSharding(CPU, row0, rows, seq0, seq_len)
    (got,) = prefetch_to_device(iter([tokens]), sharding=cut)
    want = tokens[row0:row0 + rows, seq0:min(seq0 + seq_len + 1, 16)]
    np.testing.assert_array_equal(got.numpy(), want)
    images = np.random.default_rng(0).standard_normal((4, 3, 3, 3)).astype(np.float32)
    labels = np.arange(4, dtype=np.int32)
    (pair,) = prefetch_to_device(iter([(images, labels)]), sharding=cut)
    assert pair[0].dtype == torch.float32 and pair[1].dtype == torch.int64
    np.testing.assert_array_equal(pair[0].numpy(), images[row0:row0 + rows])
    np.testing.assert_array_equal(pair[1].numpy(), labels[row0:row0 + rows])


def test_host_share_is_writable_from_a_memmap(corpus):
    """A memmap's slice is read-only; the share is a new array that
    ``torch.from_numpy`` takes without a warning."""
    mm = np.memmap(corpus, dtype=np.uint16, mode="r")[:32].reshape(2, 16)
    share = BatchSharding(CPU, 0, 2, 0, 8).host_share(mm)
    assert share.flags.writeable and share.flags.c_contiguous and share.dtype == np.int64
    np.testing.assert_array_equal(share, mm[:, :9])


def test_file_fed_trainer_through_prefetch(corpus):
    """The trainer fed from the file through prefetch_to_device steps as it
    does on ``to_device`` of the same batches: equal losses (exact)."""
    ds = TokenFileDataset(corpus, batch_size=2, seq_len=8, seed=3)
    losses = []
    for feed in ("prefetch", "to_device"):
        tr = ShardedTrainer("transformer-tiny", batch_size=2, seq_len=8, device="cpu")
        state = tr.init(seed=0)
        batches = list(ds.batches())[:3]
        it = (prefetch_to_device(iter(batches), sharding=tr.batch_sharding)
              if feed == "prefetch" else map(tr.to_device, batches))
        run = []
        for b in it:
            state, loss = tr.step(state, b)
            run.append(float(loss))
        losses.append(run)
    assert losses[0] == losses[1] and all(np.isfinite(losses[0]))
