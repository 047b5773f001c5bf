"""The launch counters' accounting under CUDA graphs, and the capturable
optimizer the captured step runs, on the CPU."""

import importlib

import numpy as np
import pytest
import torch

from gpuschedule_tpu_torch.ops import launches
from gpuschedule_tpu_torch.ops import overhead_probe as op
from gpuschedule_tpu_torch.parallel.train import make_optimizer

# the module, not the op of the same name that ``ops`` exports
fa = importlib.import_module("gpuschedule_tpu_torch.ops.flash_attention")


def test_recording_takes_back_and_replays_every_counter():
    """What a capture counted, in any op module, is taken back from the
    counters and added again on each replay."""
    fa_before, op_before = dict(fa.LAUNCHES), dict(op.LAUNCHES)
    with launches.recording() as recorded:
        fa.LAUNCHES["flash_fwd"] += 2
        fa.LAUNCHES["flash_bwd_dkdv"] += 1
        op.LAUNCHES["probe_copy"] += 3
    assert fa.LAUNCHES == fa_before and op.LAUNCHES == op_before
    assert sorted((name, n) for _, name, n in recorded) == [
        ("flash_bwd_dkdv", 1), ("flash_fwd", 2), ("probe_copy", 3)]
    for _ in range(2):
        launches.replayed(recorded)
    assert fa.LAUNCHES["flash_fwd"] == fa_before["flash_fwd"] + 4
    assert fa.LAUNCHES["flash_bwd_dkdv"] == fa_before["flash_bwd_dkdv"] + 2
    assert fa.LAUNCHES["flash_bwd_dq"] == fa_before["flash_bwd_dq"]
    assert op.LAUNCHES["probe_copy"] == op_before["probe_copy"] + 6
    fa.reset_launches()
    op.reset_launches()


def test_recording_takes_back_on_failure():
    """A capture that raises leaves the counters as they were."""
    before = dict(fa.LAUNCHES)
    with pytest.raises(RuntimeError):
        with launches.recording():
            fa.LAUNCHES["flash_fwd"] += 1
            raise RuntimeError("capture failed")
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("decay_steps", [None, 4])
def test_capturable_optimizer_takes_the_eager_steps(decay_steps):
    """The capturable (fused, device-rate) adamw the card's captured step
    runs against the multi-tensor adamw of the eager step, with the clip
    and the schedule: the same parameters after 4 steps (f32, 1e-6)."""
    rng = np.random.default_rng(3)
    init = [rng.standard_normal(shape).astype(np.float32) for shape in ((16, 8), (8,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in init] for _ in range(4)]
    finals = []
    for capturable in (True, False):
        params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
        opt = make_optimizer(params, 1e-2, warmup_steps=2, decay_steps=decay_steps,
                             grad_clip=1.0, capturable=capturable)
        assert isinstance(opt.adamw.param_groups[0]["lr"], torch.Tensor) == capturable
        for step in grads:
            for p, g in zip(params, step):
                p.grad = torch.from_numpy(g.copy())
            opt.step()
        finals.append([p.detach().numpy() for p in params])
    for a, b in zip(*finals):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
