"""The pipeline's stage compute, eager on the CPU and captured on the card.

Two pp stages run here on two threads of one process, as the tp tests run
their ranks: ``torch.distributed.all_reduce`` is replaced, for the test, by
a sum across the threads behind a barrier, and the mesh's device mesh by
one that gives each thread its stage.

- On the CPU :class:`PipelinedLM` takes no capture path (``capturable``
  false, no stage graphs), and its losses are the one-rank trainer's on the
  same parameters and global batch: the first exactly (the same
  computation in another grouping, bf16 activations between the same
  blocks), the next two within LOSS_RTOL.
- The card's path (:class:`_CapturedStage`: one graph a microbatch's stage
  forward and one its backward, the parameters' gradients summed into
  static buffers, the input's handed on) runs here with a stand-in capture
  whose "graph" runs the captured code at each replay: its losses and
  parameters equal the eager stage's to the bit, under gpipe (one step:
  the stand-in cannot replay a forward's autograd graph) and remat (three
  steps), for a dense and an MoE model.  The real graphs are held to the
  eager pipeline on the card by ``chip_smoke.py``'s phase 16.
"""

import threading

import pytest
import torch

import gpuschedule_tpu_torch.parallel.pipeline as pipeline
from gpuschedule_tpu_torch.parallel import Mesh, PipelinedLM, ShardedTrainer

LOSS_RTOL = 2e-3  # chip_smoke's bound for two computations of one loss in bf16


class _Stages:
    """Two stage threads: their all-reduce (a sum behind a barrier) and
    their device mesh (each thread's pp coordinate)."""

    def __init__(self, n=2):
        self.barrier, self.slots, self.me = threading.Barrier(n), [None] * n, threading.local()
        self.n = n

    def all_reduce(self, t, op=None, group=None):
        self.slots[self.me.rank] = t.clone()
        self.barrier.wait()
        total = torch.stack(self.slots).sum(0)
        self.barrier.wait()
        t.copy_(total)

    def get_group(self, axis):
        return axis

    def get_local_rank(self, axis):
        return self.me.rank if axis == "pp" else 0

    def run(self, monkeypatch, fn):
        """[fn(stage) for each stage], on the threads."""
        monkeypatch.setattr(torch.distributed, "all_reduce", self.all_reduce)
        out, errors = [None] * self.n, []

        def go(rank):
            self.me.rank = rank
            try:
                out[rank] = fn(rank)
            except Exception as e:  # noqa: BLE001  (re-raised below)
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=go, args=(r,)) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert not any(t.is_alive() for t in threads)
        return out


def _pipeline(stages, model, schedule):
    mesh = Mesh({"pp": 2, "dp": 1, "sp": 1, "tp": 1}, torch.device("cpu"), stages)
    return PipelinedLM(model, mesh, batch_size=8, seq_len=32, num_microbatches=4,
                       schedule=schedule)


def test_the_cpu_pipeline_takes_no_capture_path_and_trains_as_one_rank(monkeypatch):
    stages = _Stages()

    def stage(rank):
        trainer = _pipeline(stages, "transformer-tiny", "gpipe")
        state, tokens = trainer.init(seed=0), trainer.make_batch(seed=0)
        losses = []
        for _ in range(3):
            state, loss = trainer.step(state, tokens)
            losses.append(loss.item())
        return trainer.capturable, dict(trainer._graphs), losses

    (cap0, graphs0, losses), (cap1, graphs1, losses1) = stages.run(monkeypatch, stage)
    assert not cap0 and not cap1 and graphs0 == graphs1 == {}
    assert losses == losses1
    one = ShardedTrainer("transformer-tiny", batch_size=8, seq_len=32, device="cpu")
    state, tokens = one.init(seed=0), one.make_batch(seed=0)
    ref = []
    for _ in range(3):
        state, loss = one.step(state, tokens)
        ref.append(loss.item())
    assert losses[0] == ref[0]
    assert losses[1:] == pytest.approx(ref[1:], rel=LOSS_RTOL)


class _StandInGraph:
    """A captured graph's stand-in: the captured code runs at each replay,
    its first outputs kept as the graph's static ones and refilled after."""

    def __init__(self, body):
        self.body, self.out = body, None

    def replay(self):
        out = self.body()
        if self.out is None:
            self.out = out
        else:
            with torch.no_grad():
                news = out if isinstance(out, tuple) else (out,)
                olds = self.out if isinstance(self.out, tuple) else (self.out,)
                for old, new in zip(olds, news):
                    if old is not None:
                        old.copy_(new)
        return self.out


@pytest.mark.parametrize("model, schedule, steps", [
    ("transformer-tiny", "gpipe", 1), ("transformer-tiny", "remat", 3),
    ("moe-tiny", "gpipe", 1), ("moe-tiny", "remat", 3)])
def test_the_captured_stage_computes_the_eager_stages_step(monkeypatch, model, schedule, steps):
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(pipeline._CapturedStage, "_capture",
                        lambda self, body: _StandInGraph(body))
    stages = _Stages()

    def stage(rank, captured):
        trainer = _pipeline(stages, model, schedule)
        state, tokens = trainer.init(seed=0), trainer.make_batch(seed=0)
        blocks = [p for name, p in state.model.named_parameters() if name.startswith("blocks.")]
        compute = pipeline._CapturedStage(
            lambda x: trainer._run_stage(state.model, x), schedule == "gpipe",
            trainer.aux_weight, blocks, trainer.num_microbatches)
        losses = []
        for _ in range(steps):
            if captured:
                state, loss = trainer._update(state, tokens, compute)
            else:
                state, loss = trainer._eager_step(state, tokens)
            losses.append(loss.item())
        return losses, [p.detach().clone() for p in state.model.parameters()]

    eager = stages.run(monkeypatch, lambda rank: stage(rank, False))
    captured = stages.run(monkeypatch, lambda rank: stage(rank, True))
    for (e_losses, e_params), (c_losses, c_params) in zip(eager, captured):
        assert c_losses == e_losses
        assert all(torch.equal(a, b) for a, b in zip(c_params, e_params))
