"""Checkpoint, restore and reshard of a trainer's state.

Counterpart of ``gpuschedule_tpu/parallel/checkpoint.py``: the mechanism
behind the seconds the simulator charges for suspend, migrate and
grow-shrink (``sim/overhead.py``).  :func:`save_state` writes a
:class:`~gpuschedule_tpu_torch.parallel.train.TrainState` to a directory,
:func:`restore_state` reads it onto a target trainer, on the same mesh or
another dp x sp factorisation, and :func:`reshard_state` makes the same
move in memory.  The format is ``torch.distributed.checkpoint``'s (one
``.distcp`` file a writing rank and a ``.metadata``), which ships with
PyTorch.

A checkpoint holds one flat dict of tensors (:func:`state_dict`):

- ``model.<name>``: the model's ``state_dict``;
- ``optimizer.<name>.exp_avg``, ``.exp_avg_sq`` and ``.step``: adamw's
  moments and count for each parameter (optax's ``mu``, ``nu``, ``count``);
- ``optimizer.count``: the schedule's position (``LambdaLR.last_epoch``,
  optax's ``scale_by_schedule`` count);
- ``optimizer.grad_clip`` and ``optimizer.schedule``: 1 where the
  optimizer clips, or has a schedule, else 0: the two settings that change
  the JAX ``opt_state`` tree.  A restore across them raises ``ValueError``,
  as the JAX restore's tree mismatch does; other settings (the rate, the
  warmup and decay lengths, the clip's threshold) come from the target
  trainer, as they do there.

Any dp x sp x tp layout restores onto any other: the target trainer
builds its own state and the values are loaded into it.  A pipeline's
state (:class:`~gpuschedule_tpu_torch.parallel.pipeline.PipelinedLM`)
enters the dict under the whole model's names (a stage's block i is
block ``first_layer + i``), so a checkpoint of any pp layout holds the
one-rank model's keys, each rank writes and reads its stage's blocks, and
the replicated embedding and head are written once.  Over a dp x sp
mesh every rank holds the whole state.  Over tp a split parameter and its
moments are entered as ``DTensor``s of the rank's shard (``Shard`` on the
partition table's dim over the mesh's tp axis, replicated over the
others), so the checkpoint holds each whole tensor at its global shape
and ``torch.distributed.checkpoint`` reads into each target shard just
its slice, whatever layout wrote it.  Over several ranks it gathers the
ranks' plans on the default group and writes each replicated tensor (and
each shard) once.
"""

from __future__ import annotations

import re
import shutil
import warnings
from contextlib import contextmanager
from pathlib import Path
from typing import Dict

import torch
import torch.distributed as dist

from gpuschedule_tpu_torch.parallel.pipeline import whole_names
from gpuschedule_tpu_torch.parallel.tp import NO_TP, Tp, param_partition_spec
from gpuschedule_tpu_torch.parallel.train import Optimizer, TrainState

__all__ = ["save_state", "restore_state", "reshard_state", "state_dict", "load_state_dict"]

_MISMATCH = (
    "does not match the target trainer's state structure. Likely causes: a different "
    "model config, or different optimizer hyperparameters (warmup_steps/decay_steps/"
    "grad_clip change the opt_state pytree). A different MESH shape alone is fine — that "
    "resharding is supported."
)


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _barrier() -> None:
    if _distributed():
        dist.barrier()


@contextmanager
def _one_process_quietly():
    """``torch.distributed.checkpoint`` warns on every call without a
    process group that it assumes one process: that is what is meant."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def _split(state: TrainState):
    """``name -> wrap`` for the model's parameters: over tp a split one's
    local tensor (the parameter or a moment) becomes a ``DTensor`` of
    the whole (``Shard`` on its dim over the tp axis), a replicated one
    stays as it is.  The ``DTensor`` is a view: loading into it loads the
    rank's own tensor."""
    tp = getattr(state.model, "tp", NO_TP)
    if tp.size == 1:
        return lambda name, t: t
    from torch.distributed.tensor import DTensor, Replicate, Shard

    device_mesh = state.mesh.device_mesh

    def wrap(name, t):
        dim = param_partition_spec(name, t.dim())
        if dim is None:
            return t
        placements = [Replicate()] * (device_mesh.ndim - 1) + [Shard(dim)]
        return DTensor.from_local(t, device_mesh, placements, run_check=False)
    return wrap


def _shards(t: torch.Tensor):
    """(the tp of a ``DTensor`` that :func:`_split` made, its split dim),
    or None for a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return None
    mesh = t.device_mesh
    tp = Tp(mesh.size(mesh.ndim - 1), mesh.get_local_rank("tp"), mesh.get_group("tp"))
    return tp, t.placements[-1].dim


def _copy_into(target: torch.Tensor, source: torch.Tensor) -> None:
    """Copy ``source`` into ``target``, either a plain tensor or a split
    one of :func:`_split`: a split source is gathered over its tp (every
    rank calls this, in one order), a split target takes its slice."""
    src = _shards(source)
    whole = source if src is None else src[0].gather(source.to_local(), src[1])
    dst = _shards(target)
    if dst is None:
        target.copy_(whole)
    else:
        target.to_local().copy_(dst[0].shard(whole, dst[1]))


def _flags(opt: Optimizer) -> Dict[str, int]:
    return {"grad_clip": int(opt.grad_clip is not None), "schedule": int(opt.scheduled)}


def _new_step(adamw: torch.optim.AdamW, p: torch.Tensor) -> torch.Tensor:
    """A zero step count in the form adamw keeps it for ``p``: on the
    device for a capturable or fused adamw, a CPU scalar otherwise."""
    group = adamw.param_groups[0]
    if group["capturable"] or group["fused"]:
        return torch.zeros((), dtype=torch.float32, device=p.device)
    return torch.tensor(0.0, dtype=torch.float32)


def state_dict(state: TrainState, *, materialize: bool = False) -> Dict[str, torch.Tensor]:
    """The flat dict of tensors a checkpoint holds (module docstring).

    The model's and the optimizer's entries are the state's own tensors,
    so loading into the dict loads into the state.  A parameter adamw has
    not stepped yet gets zero moments and a zero count, as optax's init
    gives; with ``materialize`` they are put into the optimizer, so that
    they too are loaded in place."""
    model, opt = state.model, state.optimizer
    adamw = opt.adamw
    wrap = _split(state)
    out: Dict[str, torch.Tensor] = {f"model.{k}": wrap(k, v)
                                    for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        st = adamw.state.get(p)
        if not st:
            st = {"step": _new_step(adamw, p), "exp_avg": torch.zeros_like(p),
                  "exp_avg_sq": torch.zeros_like(p)}
            if materialize:
                adamw.state[p] = st
        for key in ("exp_avg", "exp_avg_sq"):
            out[f"optimizer.{name}.{key}"] = wrap(name, st[key])
        out[f"optimizer.{name}.step"] = st["step"]
    out["optimizer.count"] = torch.tensor(opt.schedule.last_epoch, dtype=torch.int64)
    out.update({f"optimizer.{k}": torch.tensor(v, dtype=torch.int64)
                for k, v in _flags(opt).items()})
    return whole_names(out, state.first_layer)


def _whole_shapes(state: TrainState, template: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """The keys and shapes of the whole model's dict of which ``template``
    (:func:`state_dict` of ``state``) is a rank's: a pipeline stage's
    blocks stand for every block of the model, which all have one form."""
    shapes = {k: tuple(v.shape) for k, v in template.items()}
    if state.mesh is None or state.mesh.shape["pp"] == 1:
        return shapes
    n_layers = state.model.cfg.n_layers
    whole = {}
    for k, shape in shapes.items():
        m = re.match(r"(model|optimizer)\.blocks\.(\d+)\.(.*)$", k)
        if m is None:
            whole[k] = shape
        else:
            whole.update({f"{m[1]}.blocks.{i}.{m[3]}": shape for i in range(n_layers)})
    return whole


def _check_structure(template: Dict[str, tuple], shapes: Dict[str, tuple], where) -> None:
    missing = sorted(set(template) - set(shapes))
    extra = sorted(set(shapes) - set(template))
    wrong = sorted(k for k in set(template) & set(shapes)
                   if tuple(template[k]) != tuple(shapes[k]))
    if missing or extra or wrong:
        detail = "; ".join(f"{what}: {keys[:4]}{' ...' if len(keys) > 4 else ''}"
                           for what, keys in (("missing", missing), ("unexpected", extra),
                                              ("other shapes", wrong)) if keys)
        raise ValueError(f"{where} {_MISMATCH} Original error: {detail}")


def _finish(state: TrainState, template: Dict[str, torch.Tensor], where) -> TrainState:
    """Hold the loaded optimizer settings to the target's and put the
    schedule at the loaded position."""
    want = _flags(state.optimizer)
    got = {k: int(template[f"optimizer.{k}"]) for k in want}
    if got != want:
        raise ValueError(f"{where} {_MISMATCH} Original error: the checkpoint's optimizer "
                         f"has {got}, the target's {want}")
    state.optimizer.seek(int(template["optimizer.count"]))
    return state


def load_state_dict(trainer, sd: Dict[str, torch.Tensor]) -> TrainState:
    """A new state on ``trainer`` holding the values of ``sd`` (the form
    :func:`state_dict` gives of the whole model, on any device): the
    in-memory restore."""
    state = trainer.init(seed=0)
    template = state_dict(state, materialize=True)
    _check_structure(_whole_shapes(state, template), {k: tuple(v.shape) for k, v in sd.items()},
                     "the state")
    with torch.no_grad():
        for k, t in template.items():
            _copy_into(t, sd[k])
    return _finish(state, template, "the state")


def save_state(state: TrainState, path, *, overwrite: bool = True) -> str:
    """Write ``state`` to the directory ``path`` and return its absolute
    path.  ``overwrite=True`` (the default) replaces a checkpoint already
    there, as the scheduler's repeated suspends of one job need; the new
    one is written beside it first and moved into place when whole.  Over
    several ranks every rank calls it; rank 0 moves the directory."""
    from torch.distributed.checkpoint import FileSystemWriter
    from torch.distributed.checkpoint import save as dcp_save

    path = Path(path).absolute()
    if path.exists() and not overwrite:
        raise FileExistsError(f"a checkpoint exists at {path} and overwrite=False")
    partial = path.with_name(path.name + ".partial")
    rank0 = not _distributed() or dist.get_rank() == 0
    if rank0 and partial.exists():
        shutil.rmtree(partial)
    _barrier()
    with _one_process_quietly():
        dcp_save(state_dict(state), storage_writer=FileSystemWriter(str(partial)),
                 no_dist=not _distributed())
    if rank0:
        if path.is_dir():
            shutil.rmtree(path)
        elif path.exists():
            path.unlink()
        partial.rename(path)
    _barrier()
    return str(path)


def restore_state(trainer, path) -> TrainState:
    """Read the checkpoint at ``path`` onto ``trainer``: a new state on its
    device and mesh (any dp x sp x tp factorisation, each rank reading its
    own shards; the trainer's step then
    drops the graphs of its old state and captures anew).  The checkpoint's
    keys and shapes are held to the target's before anything is read;
    a mismatch raises ``ValueError``, as does a different ``grad_clip`` or
    schedule setting."""
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint import load as dcp_load

    path = Path(path).absolute()
    reader = FileSystemReader(str(path))
    metadata = reader.read_metadata()
    state = trainer.init(seed=0)
    template = state_dict(state, materialize=True)
    where = f"checkpoint at {path}"
    _check_structure(_whole_shapes(state, template), {k: tuple(getattr(m, "size", ()))
                                for k, m in metadata.state_dict_metadata.items()}, where)
    with _one_process_quietly():
        dcp_load(template, storage_reader=reader, no_dist=not _distributed())
    return _finish(state, template, where)


def reshard_state(trainer, state: TrainState) -> TrainState:
    """The same move as :func:`restore_state` with no filesystem: ``state``
    (from a trainer with another dp x sp x tp factorisation, or on another
    device) copied into a new state on ``trainer``; over tp a collective,
    which every rank calls."""
    return load_state_dict(trainer, state_dict(state))
