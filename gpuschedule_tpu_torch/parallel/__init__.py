"""Parallelism: the mesh, the sp rings and gather, tensor parallelism, the train
step and the pipeline.

Where the JAX package shards one program with ``jax.sharding``, the port
runs one rank of a :class:`Mesh` a process (``torchrun``), its collectives
on the mesh's process groups: NCCL on cards, gloo on the CPU.
"""

from gpuschedule_tpu_torch.parallel.mesh import Mesh, make_mesh
from gpuschedule_tpu_torch.parallel.ringattn import ring_attention
from gpuschedule_tpu_torch.parallel.ringflash import ring_flash_attention
from gpuschedule_tpu_torch.parallel.tp import Tp, param_partition_spec
from gpuschedule_tpu_torch.parallel.train import ShardedTrainer, TrainState, make_optimizer
from gpuschedule_tpu_torch.parallel.pipeline import PipelinedLM, stack_stage_params

__all__ = [
    "Mesh",
    "make_mesh",
    "ring_attention",
    "ring_flash_attention",
    "Tp",
    "param_partition_spec",
    "ShardedTrainer",
    "TrainState",
    "make_optimizer",
    "PipelinedLM",
    "stack_stage_params",
]
