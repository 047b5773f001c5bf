"""Device mesh: the JAX package's four named axes over ``torch.distributed`` ranks.

Counterpart of ``gpuschedule_tpu/parallel/mesh.py``.  One mesh, four named
axes — ``pp`` (pipeline), ``dp`` (data), ``sp`` (sequence), ``tp`` (tensor),
outermost first — over the ranks of the world, one device a rank (the
launcher's: ``torchrun`` sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``).
With more than one rank the mesh is a ``DeviceMesh``
(``init_device_mesh``), whose per-axis process groups carry the collectives
(NCCL on cards, gloo on the CPU); so it is on one rank too when a launcher
started one.  A mesh of one rank needs no launcher and no process group,
as the JAX function works on one device.

The mesh spans the whole world: JAX can lay a mesh over any subset of the
devices one program sees, but here every rank is its own program, so a
mesh whose size is not the world's raises.  The profiler measures
smaller meshes: :func:`sub_mesh` lays one over the first k ranks, every
rank building its groups and the ranks outside it getting None.

Besides the axes' groups a mesh of several ranks has a *data group*:
the dp x sp ranks that share this rank's pp and tp coordinates, over which
the gradients, the loss and the MoE's token counts are summed (the tp
ranks hold shards of one model, the pp ranks its stages, not replicas).
The pp axis's group (``group("pp")``) is a pipeline's *stage line*: the
ranks of one dp column along pp, which exchange the boundary activations
(:mod:`.pipeline`).  ``init_device_mesh`` makes the axes' groups and
:func:`_build` the data groups in one order on every rank, as a group
must be made by every rank of the world.
"""

from __future__ import annotations

from dataclasses import dataclass
import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from gpuschedule_tpu_torch import resolve_device

AXES = ("pp", "dp", "sp", "tp")


@dataclass(frozen=True)
class Mesh:
    """A ``(pp, dp, sp, tp)`` mesh as this rank sees it: the axis sizes
    (``shape``, like JAX's ``Mesh.shape``), this rank's device, and the
    ``DeviceMesh`` whose groups run the collectives (None for one rank)."""

    shape: Dict[str, int]
    device: torch.device
    device_mesh: Optional[object] = None  # torch.distributed.device_mesh.DeviceMesh
    data_group: Optional[object] = None   # this rank's dp x sp ranks (one tp coordinate)

    @property
    def size(self) -> int:
        """The mesh's ranks."""
        return math.prod(self.shape.values())

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        if self.device_mesh is None:
            raise RuntimeError(
                f"a mesh of one rank has no process group for {axis!r}; launch the ranks "
                "with torchrun and build the mesh there"
            )
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(axis)


def world_size() -> int:
    """Ranks in the default process group; 1 when there is none."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(
    *,
    dp: Optional[int] = None,
    sp: int = 1,
    tp: int = 1,
    pp: int = 1,
    devices: Optional[int] = None,
    device=None,
) -> Mesh:
    """Build a ``(pp, dp, sp, tp)`` mesh over ``devices`` ranks (default:
    every rank of the world).

    ``dp`` defaults to "whatever is left": n_devices // (pp * sp * tp).  The
    axis checks and their messages are the JAX function's.  ``device`` is
    this rank's device type: the card unless ``"cpu"`` is passed
    (:func:`~gpuschedule_tpu_torch.resolve_device`); a CUDA rank uses its
    current device."""
    world = world_size()
    n = world if devices is None else devices
    if sp < 1 or tp < 1 or pp < 1:
        raise ValueError(f"axis sizes must be >= 1: pp={pp}, sp={sp}, tp={tp}")
    if n % (pp * sp * tp) != 0:
        raise ValueError(f"{n} devices not divisible by pp*sp*tp={pp * sp * tp}")
    inferred_dp = n // (pp * sp * tp)
    if dp is None:
        dp = inferred_dp
    if pp * dp * sp * tp != n:
        raise ValueError(f"pp*dp*sp*tp={pp * dp * sp * tp} != {n} devices")
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices in a world of {world} ranks: the mesh spans every rank, "
            f"one device each (launch {n} ranks, e.g. torchrun --nproc-per-node {n})"
        )
    return _build(n, (pp, dp, sp, tp), device)


def sub_mesh(n: int, *, dp: int, sp: int = 1, tp: int = 1, pp: int = 1, device=None):
    """A ``(pp, dp, sp, tp)`` mesh over the first ``n`` ranks of the world.
    Every rank calls it, in the same order as every other group it builds
    (each group is made by every rank of the world); the ranks outside
    the mesh get None."""
    if pp * dp * sp * tp != n or n > world_size():
        raise ValueError(f"pp*dp*sp*tp={pp * dp * sp * tp} over the first {n} of "
                         f"{world_size()} ranks")
    return _build(n, (pp, dp, sp, tp), device)


def _build(n: int, sizes, device) -> Optional[Mesh]:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    shape = dict(zip(AXES, sizes))
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(shape, dev)  # one rank, no launcher: no groups to build
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    world = world_size()
    ranks = torch.arange(n).reshape(sizes)
    device_mesh = (init_device_mesh(dev.type, sizes, mesh_dim_names=AXES) if n == world
                   else DeviceMesh(dev.type, ranks, mesh_dim_names=AXES))
    me, data_group = dist.get_rank(), None
    for p in range(sizes[0]):
        for t in range(sizes[3]):
            members = ranks[p, :, :, t].flatten().tolist()
            group = dist.group.WORLD if len(members) == world else dist.new_group(members)
            if me in members:
                data_group = group
    if me >= n:
        return None
    return Mesh(shape, dev, device_mesh, data_group)
