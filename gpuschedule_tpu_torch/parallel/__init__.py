"""The single-device train step (multi-GPU meshes are not ported yet)."""

from gpuschedule_tpu_torch.parallel.train import ShardedTrainer, TrainState, make_optimizer

__all__ = ["ShardedTrainer", "TrainState", "make_optimizer"]
