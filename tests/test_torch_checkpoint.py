"""Checkpoint, restore and reshard (``parallel/checkpoint.py``) and the
JAX state carried across (``convert.opt_state_from_jax``), on the CPU.

- The round trip is exact: parameters, adamw's moments and count, the
  schedule's position and the rate it gives, with warmup, decay and a clip.
- A restored run's losses equal the uninterrupted run's exactly: the same
  float operations on the same values.
- Restores that the JAX ``opt_state`` tree would refuse raise with its
  words ("optimizer hyperparameters"); one the tree allows does not.
- Resume parity: the JAX trainer's state after 3 steps (parameters and
  optax adamw's state) carried across, then 2 steps on both sides on the
  same batches: losses within 5e-3, ``tests/test_torch_train.py``'s bound
  (bf16 logits that differ by an ulp, averaged over the batch).
- The elastic loop: the JAX simulator's Optimus shrink drives a save and
  restore of the port's trainer, as ``tests/test_elastic_loop.py`` drives
  the JAX trainer's.

The cross-mesh restore (dp 4 -> dp 2 x sp 2) runs in the gloo spawn of
``tests/test_torch_ring_dist.py``.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gpuschedule_tpu.cluster import SimpleCluster  # noqa: E402
from gpuschedule_tpu.parallel import ShardedTrainer as JaxTrainer  # noqa: E402
from gpuschedule_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from gpuschedule_tpu.policies.optimus import OptimusPolicy  # noqa: E402
from gpuschedule_tpu.profiler import CurveCache, GoodputCurve  # noqa: E402
from gpuschedule_tpu.sim import Job, JobState, Simulator  # noqa: E402
from gpuschedule_tpu.sim.overhead import migrate_seconds  # noqa: E402
from gpuschedule_tpu_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from gpuschedule_tpu_torch.data import synthetic_lm_batches  # noqa: E402
from gpuschedule_tpu_torch.parallel import ShardedTrainer  # noqa: E402
from gpuschedule_tpu_torch.parallel.checkpoint import (  # noqa: E402
    load_state_dict,
    reshard_state,
    restore_state,
    save_state,
    state_dict,
)

OPT = dict(warmup_steps=1, decay_steps=4, grad_clip=0.5)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the tiny CPU steps here: the driver runs six
    test workers on the box's cores, where more threads a step only wait
    on each other.  Restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(name="transformer-tiny", **kw):
    return ShardedTrainer(name, batch_size=2, seq_len=16, device="cpu",
                          **{"learning_rate": 3e-3, **OPT, **kw})


def _batches(n, seq=16, start=0):
    return list(synthetic_lm_batches(batch_size=2, seq_len=seq, vocab=8192, num_batches=start + n,
                                     start=start, seed=1))


def _run(tr, state, batches):
    losses = []
    for b in batches:
        state, loss = tr.step(state, tr.to_device(b))
        losses.append(float(loss))
    return state, losses


def _assert_same(a, b):
    sa, sb = state_dict(a), state_dict(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_round_trip_is_exact(tmp_path):
    tr = _trainer()
    state, _ = _run(tr, tr.init(seed=0), _batches(2))
    path = save_state(state, tmp_path / "ck")
    restored = restore_state(_trainer(), path)
    _assert_same(state, restored)
    assert restored.optimizer.count() == state.optimizer.count() == 2
    assert restored.optimizer.schedule.last_epoch == 2
    assert restored.optimizer.adamw.param_groups[0]["lr"] == \
        state.optimizer.adamw.param_groups[0]["lr"] > 0
    assert restored.model is not state.model


def test_restored_losses_equal_the_uninterrupted_run(tmp_path):
    """Three steps, save, restore onto a new trainer, three more: the
    losses and the final parameters equal a straight run of six (exact)."""
    batches = _batches(6)
    tr = _trainer()
    straight_state, straight = _run(tr, tr.init(seed=0), batches)
    first = _trainer()
    state, losses = _run(first, first.init(seed=0), batches[:3])
    second = _trainer()
    state, more = _run(second, restore_state(second, save_state(state, tmp_path / "ck")),
                       batches[3:])
    assert losses + more == straight
    _assert_same(state, straight_state)


def test_repeated_save_overwrites(tmp_path):
    tr = _trainer()
    state = tr.init(seed=0)
    save_state(state, tmp_path / "ck")
    state, _ = _run(tr, state, _batches(1))
    assert save_state(state, tmp_path / "ck") == str(tmp_path / "ck")
    _assert_same(state, restore_state(_trainer(), tmp_path / "ck"))
    assert not (tmp_path / "ck.partial").exists()
    with pytest.raises(FileExistsError):
        save_state(state, tmp_path / "ck", overwrite=False)


def test_unstepped_state_round_trips(tmp_path):
    """A fresh state holds zero moments and counts, as optax's init does."""
    state = _trainer().init(seed=3)
    restored = restore_state(_trainer(), save_state(state, tmp_path / "ck"))
    _assert_same(state, restored)
    assert restored.optimizer.count() == 0


@pytest.mark.parametrize("target", [
    dict(grad_clip=None), dict(warmup_steps=0, decay_steps=None),
    dict(name="transformer-small"), dict(name="moe-tiny"),
], ids=["no-clip", "no-schedule", "other-model", "moe-model"])
def test_mismatch_raises_naming_the_optimizer(tmp_path, target):
    """The restores whose JAX opt_state (or parameter) tree differs."""
    save_state(_trainer().init(seed=0), tmp_path / "ck")
    with pytest.raises(ValueError, match="optimizer hyperparameters"):
        restore_state(_trainer(**target), tmp_path / "ck")


def test_same_tree_other_settings_restore(tmp_path):
    """Another warmup, decay, clip threshold or rate keeps the JAX tree,
    so the restore goes through, and the target's settings hold."""
    tr = _trainer()
    state, _ = _run(tr, tr.init(seed=0), _batches(2))
    save_state(state, tmp_path / "ck")
    other = _trainer(warmup_steps=3, decay_steps=9, grad_clip=2.0, learning_rate=1e-3)
    restored = restore_state(other, tmp_path / "ck")
    assert restored.optimizer.schedule.last_epoch == 2
    assert restored.optimizer.adamw.param_groups[0]["lr"] == pytest.approx(1e-3 * 2 / 3)


def test_reshard_state_keeps_values():
    tr = _trainer()
    state, _ = _run(tr, tr.init(seed=0), _batches(2))
    moved = reshard_state(_trainer(), state)
    _assert_same(state, moved)
    assert moved.model is not state.model


def test_tp_layout_raises(tmp_path):
    """A pp layout's state enters a checkpoint under the whole model's
    names (a stage's block i is block ``first_layer + i``), so a one-rank
    checkpoint restores onto a pipeline stage: the stage's blocks, the
    embedding and the head, each value equal.  A checkpoint of another
    model raises before anything is read.  tp layouts restore in
    ``tests/test_torch_tp_dist.py``, pp layouts across ranks in
    ``tests/test_torch_pipeline_dist.py``."""
    from gpuschedule_tpu_torch.parallel import make_optimizer
    from gpuschedule_tpu_torch.parallel.checkpoint import state_dict

    trainer = _trainer()
    state, _ = trainer.step(trainer.init(seed=0), trainer.make_batch(seed=0))
    path = save_state(state, tmp_path / "one")
    mesh = SimpleNamespace(shape={"pp": 2, "dp": 1, "sp": 1, "tp": 1})

    def stage_init(seed=0):
        stage = trainer.init(seed=seed)
        stage.model.blocks = stage.model.blocks[1:]  # the second of two stages
        stage.mesh, stage.first_layer = mesh, 1
        stage.optimizer = make_optimizer(stage.model.parameters(), 3e-3, **OPT)
        return stage

    stage = restore_state(SimpleNamespace(init=stage_init, mesh=mesh), path)
    saved, got = state_dict(state), state_dict(stage)
    assert "model.blocks.1.attn.query.kernel" in got and "model.blocks.0.ln1.scale" not in got
    for key, value in got.items():
        torch.testing.assert_close(value, saved[key], rtol=0, atol=0, msg=key)
    other = SimpleNamespace(init=lambda seed=0: _trainer("moe-tiny").init(seed=seed), mesh=mesh)
    with pytest.raises(ValueError, match="optimizer hyperparameters"):
        restore_state(other, path)


@pytest.mark.parametrize("name", ["transformer-tiny", "moe-tiny"])
def test_resume_parity_with_jax(name):
    """The JAX trainer takes 3 steps; its parameters and opt_state come
    across (``params_from_jax``, ``opt_state_from_jax``) into the port's
    trainer; both take 2 more steps on the same batches.  Losses within
    5e-3.  With the schedule mid-warmup-decay, a position or count off by
    one moves the next losses by more than that."""
    kw = dict(batch_size=2, seq_len=16, learning_rate=3e-3, **OPT)
    jt = JaxTrainer(name, jax_make_mesh(dp=1, devices=jax.devices()[:1]), **kw)
    jstate = jt.init(seed=0)
    batches = _batches(5)
    for b in batches[:3]:
        jstate, _ = jt.step(jstate, jnp.asarray(b))
    params, opt_state = jax.device_get(jstate)

    tr = ShardedTrainer(name, device="cpu", **kw)
    sd = {f"model.{k}": v for k, v in params_from_jax(params, tr.cfg).items()}
    sd.update(opt_state_from_jax(opt_state, tr.cfg))
    state = load_state_dict(tr, sd)
    assert state.optimizer.count() == 3 and state.optimizer.schedule.last_epoch == 3

    ref = []
    for b in batches[3:]:
        jstate, loss = jt.step(jstate, jnp.asarray(b))
        ref.append(float(loss))
    _, ours = _run(tr, state, batches[3:])
    np.testing.assert_allclose(ours, ref, atol=5e-3, rtol=0)


def test_opt_state_from_jax_reads_every_form():
    """The four opt_state forms of the JAX make_optimizer: the clip and
    schedule flags and the counts come out as the port keeps them."""
    for kw, flags in (({}, (0, 0)), (dict(grad_clip=1.0), (1, 0)),
                      (dict(warmup_steps=2), (0, 1)), (OPT, (1, 1))):
        jt = JaxTrainer("transformer-tiny", jax_make_mesh(dp=1, devices=jax.devices()[:1]),
                        batch_size=2, seq_len=16, **kw)
        params, opt_state = jax.device_get(jt.init(seed=0))
        out = opt_state_from_jax(opt_state, jt.cfg)
        assert (int(out["optimizer.grad_clip"]), int(out["optimizer.schedule"])) == flags
        assert int(out["optimizer.count"]) == 0
        names = params_from_jax(params, jt.cfg)
        assert {k for k in out if k.endswith(".exp_avg")} == {f"optimizer.{n}.exp_avg"
                                                              for n in names}


class _BridgedSim(Simulator):
    """A simulator whose resize calls also drive a runtime bridge."""

    def __init__(self, *args, bridge=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._bridge = bridge

    def resize(self, job, *, chips, speed, overhead=0.0, why=None):
        old = job.allocated_chips
        ok = super().resize(job, chips=chips, speed=speed, overhead=overhead, why=why)
        if ok and self._bridge is not None:
            self._bridge(job, old, chips)
        return ok


def test_optimus_resize_drives_the_ports_save_restore(tmp_path):
    """The JAX engine's Optimus shrink (8 -> 4 chips on the second job's
    arrival) drives a save and restore of the port's trainer at decision
    time, one rank: the moved trainer's next loss equals the unmoved one's
    (rtol 2e-4, the JAX test's), and the measured save + restore seconds
    sit where ``tests/test_elastic_loop.py`` holds the JAX mechanism's:
    ``migrate_seconds`` over them within [0.1, 100]."""
    moves = []

    def bridge(job, old_chips, new_chips):
        if job.job_id != "first" or moves:
            return
        src = ShardedTrainer(job.model_name, batch_size=8, seq_len=32, device="cpu")
        state = src.init(seed=0)
        losses = []
        for i in range(2):
            state, loss = src.step(state, src.make_batch(seed=i))
            losses.append(float(loss))
        t0 = time.perf_counter()
        path = save_state(state, tmp_path / "elastic_ckpt")
        save_s = time.perf_counter() - t0
        dst = ShardedTrainer(job.model_name, batch_size=8, seq_len=32, device="cpu")
        t0 = time.perf_counter()
        restored = restore_state(dst, path)
        restore_s = time.perf_counter() - t0
        _, moved_loss = dst.step(restored, dst.make_batch(seed=2))
        _, ref_loss = src.step(state, src.make_batch(seed=2))
        np.testing.assert_allclose(float(moved_loss), float(ref_loss), rtol=2e-4)
        assert np.isfinite(losses).all()
        moves.append({"old": old_chips, "new": new_chips, "save_s": save_s,
                      "restore_s": restore_s})

    cache = CurveCache(tmp_path / "curves.json")
    cache.put("transformer-tiny", GoodputCurve((1.0, 0.0, 1e-6)))
    jobs = [Job("first", 0.0, num_chips=4, duration=600.0, model_name="transformer-tiny"),
            Job("second", 50.0, num_chips=4, duration=600.0, model_name="transformer-tiny")]
    res = _BridgedSim(SimpleCluster(8), OptimusPolicy(curve_cache=cache, resize_overhead=5.0),
                      jobs, bridge=bridge).run()
    assert all(j.state is JobState.DONE for j in res.jobs)
    assert len(moves) == 1 and (moves[0]["old"], moves[0]["new"]) == (8, 4)
    measured = moves[0]["save_s"] + moves[0]["restore_s"]
    ratio = migrate_seconds("transformer-tiny", moves[0]["new"]) / measured
    assert measured > 0 and 0.1 <= ratio <= 100, (measured, ratio)
