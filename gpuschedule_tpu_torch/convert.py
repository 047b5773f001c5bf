"""Flax parameter trees -> this package's ``state_dict``, and optax adamw
state -> the optimizer entries of a checkpoint's dict.

The port's modules keep flax's parameter names and shapes, so the mapping
is by path alone: a ``state_dict`` name is the flax path joined by dots,
but for the LM's blocks, which flax names ``block{i}`` and the port keeps
in ``blocks.{i}`` (``block0/attn/query/kernel`` is
``blocks.0.attn.query.kernel``).  The names to fill are the state_dict of
the config's own module, built on the meta device, so the mapping follows
the modules (dense or MoE MLP, CNN) with no list of its own.  Arrays
arrive as numpy (``jax.device_get`` of the tree); nothing here imports JAX.

:func:`opt_state_from_jax` carries the JAX trainer's ``opt_state`` across
in the middle of training: adamw's moments map by the same paths, and the
counts become adamw's step and the schedule's position, in the flat form
of ``parallel/checkpoint.py``'s ``state_dict``.

A pipeline's tree (the JAX ``PipelinedLM``'s: ``embed``, ``head`` and the
blocks under ``stages``, stacked on a leading stage dim) maps onto one
stage's rank of the port's ``PipelinedLM`` (``stage=``): the embedding and
the head whole, and the stage's slice of each stacked leaf, its
``layer{i}`` the rank's ``blocks.{i}``.

Over tp both take the rank's :class:`~gpuschedule_tpu_torch.parallel.tp.Tp`
and give its shards (the partition table's slices);
:func:`unshard_state_dict` puts the shards of a tp-split ``state_dict``
back together on every tp rank.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from gpuschedule_tpu_torch.models.cnn import ResNet
from gpuschedule_tpu_torch.models.config import CnnConfig, ModelConfig
from gpuschedule_tpu_torch.models.transformer import TransformerLM
from gpuschedule_tpu_torch.parallel.tp import NO_TP, Tp, flax_path, param_partition_spec


def _leaves(tree):
    """The leaves of a nested mapping, depth first."""
    for value in tree.values():
        if isinstance(value, Mapping):
            yield from _leaves(value)
        else:
            yield value


def _get(tree: Mapping, path) -> np.ndarray:
    node = tree
    for name in path:
        node = node[name]
    return np.asarray(node)


def _stage_path(name: str, layers: int):
    """(the JAX ``PipelinedLM`` path of a stage rank's ``state_dict`` name,
    whether its leaf is stacked over stages), or None for a block past the
    stage's ``layers``."""
    block = re.match(r"blocks\.(\d+)\.(.*)$", name)
    if block is not None:
        if int(block[1]) >= layers:
            return None
        return ["stages", f"layer{block[1]}", "params", *block[2].split(".")], True
    part = "embed" if name.startswith(("embed.", "pos_embed")) else "head"
    return [part, "params", *name.split(".")], False


def params_from_jax(params: Mapping, cfg: "ModelConfig | CnnConfig",
                    tp: Tp = NO_TP, *, stage: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The state_dict of ``cfg``'s module (a ``TransformerLM``, dense or
    MoE, or a ``ResNet``) holding the flax parameters ``params`` (the
    ``"params"`` collection, or the dict that wraps it): over ``tp``, this
    rank's shard of each.  With ``stage``, ``params`` is the JAX
    ``PipelinedLM``'s tree and the state_dict that of stage ``stage``'s
    rank: the embedding, the head and the stage's blocks.  Raises
    ``KeyError`` naming the flax path of any missing leaf.  ``cfg`` may be
    the JAX package's config of the same model: a config with ``channels``
    is a CNN's."""
    if "params" in params:
        params = params["params"]
    with torch.device("meta"):
        module = ResNet(cfg) if hasattr(cfg, "channels") else TransformerLM(cfg)
    if stage is not None:
        pp = np.asarray(next(iter(_leaves(params["stages"])))).shape[0]
        layers = cfg.n_layers // pp
    out: Dict[str, torch.Tensor] = {}
    for name in module.state_dict():
        if stage is None:
            path, stacked = flax_path(name), False
        else:
            found = _stage_path(name, layers)
            if found is None:
                continue
            path, stacked = found
        try:
            arr = _get(params, path)
        except KeyError:
            raise KeyError(f"flax parameter {'/'.join(path)} is missing") from None
        if stacked:
            arr = arr[stage]
        full = torch.from_numpy(np.array(arr, dtype=np.float32))
        dim = param_partition_spec(name, full.dim()) if tp.size > 1 else None
        out[name] = tp.shard(full, dim).contiguous()
    return out


def unshard_state_dict(sd: Mapping[str, torch.Tensor], tp: Tp) -> Dict[str, torch.Tensor]:
    """The whole parameters of a tp-split model's ``state_dict`` (or of
    adamw moments named as their parameters): each split entry gathered
    over ``tp`` (:meth:`Tp.gather`, a collective: every tp rank calls it),
    the replicated ones as they are."""
    out = {}
    for name, t in sd.items():
        dim = param_partition_spec(name, t.dim()) if tp.size > 1 else None
        out[name] = tp.gather(t, dim)
    return out


def _optax_parts(opt_state) -> Tuple[object, bool, Optional[object]]:
    """(adam's state, whether a clip leads the chain, the schedule's state
    or None) of the JAX ``make_optimizer``'s ``opt_state``: ``(adam,
    decay, rate)`` for ``optax.adamw``, ``(clip, (adam, decay, rate))``
    with ``grad_clip``; the clip's state is an empty tuple, the rate's
    holds a ``count`` when there is a schedule.  Read by structure: the
    port imports no optax."""
    clipped = len(opt_state) == 2 and len(opt_state[0]) == 0
    adam, _decay, rate = opt_state[1] if clipped else opt_state
    # fields by name: every tuple has a ``count`` method
    if not {"mu", "nu", "count"} <= set(getattr(adam, "_fields", ())):
        raise ValueError(f"not the opt_state of optax.adamw: {type(adam).__name__}")
    return adam, clipped, (rate if "count" in getattr(rate, "_fields", ()) else None)


def opt_state_from_jax(opt_state, cfg: "ModelConfig | CnnConfig",
                       tp: Tp = NO_TP, *, stage: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The ``optimizer.*`` entries of a checkpoint's dict
    (``parallel.checkpoint.state_dict``) holding optax adamw's ``opt_state``
    (the JAX ``make_optimizer``'s, any of its four forms): each
    parameter's ``mu`` and ``nu`` as its ``exp_avg`` and ``exp_avg_sq``
    and adam's ``count`` as its ``step``; the schedule's ``count`` (adam's
    where there is no schedule: both advance once an update) as
    ``optimizer.count``; whether a clip and a schedule are in the chain as
    ``optimizer.grad_clip`` and ``optimizer.schedule``.  With the
    parameters (``model.`` + :func:`params_from_jax`) it loads into a
    trainer with ``load_state_dict``; over ``tp``, this rank's shards; with
    ``stage``, a JAX ``PipelinedLM``'s state for that stage's rank, under
    the rank's own names (``parallel.pipeline.whole_names`` gives the
    checkpoint's)."""
    adam, clipped, sched = _optax_parts(opt_state)
    mu = params_from_jax(adam.mu, cfg, tp, stage=stage)
    nu = params_from_jax(adam.nu, cfg, tp, stage=stage)
    step = float(np.asarray(adam.count))
    out: Dict[str, torch.Tensor] = {}
    for name in mu:
        out[f"optimizer.{name}.exp_avg"] = mu[name]
        out[f"optimizer.{name}.exp_avg_sq"] = nu[name]
        out[f"optimizer.{name}.step"] = torch.tensor(step, dtype=torch.float32)
    count = np.asarray((sched or adam).count)
    out["optimizer.count"] = torch.tensor(int(count), dtype=torch.int64)
    out["optimizer.grad_clip"] = torch.tensor(int(clipped), dtype=torch.int64)
    out["optimizer.schedule"] = torch.tensor(int(sched is not None), dtype=torch.int64)
    return out
