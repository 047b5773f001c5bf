"""What the train step's adamw costs on the card, in the three forms the
step could take.

    PYTHONPATH=. python scripts/optimizer_costs.py [--rounds 2]

For the dense cell (transformer-large, b16 x S512) and the flash cell
(transformer-long, b2 x S4096, flash attention), each adamw form in turn,
``--rounds`` times in alternating order, one JSON line each:

- ``foreach``: the multi-tensor adamw with a Python learning rate, which a
  CUDA graph cannot hold; the step runs eagerly (the trainer's eager path);
- ``foreach_capturable``: the multi-tensor adamw with ``capturable=True``
  and a device learning rate, in the captured step;
- ``fused_capturable``: the fused adamw with ``capturable=True`` and a
  device learning rate, in the captured step (what ``make_optimizer``
  builds on the card).

Each line holds the update alone (clip and adamw on one step's gradients):
its event ms over 10 calls, its device ms from a ``torch.profiler``
window of 3 calls and the kernels it launched there (ms and launches per
update); and the whole step's median ms (``time_steps``, 3 blocks of 10
after 3 steps).  It needs one CUDA card; nothing in the package imports it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from functools import partial

import torch

from gpuschedule_tpu_torch.parallel import ShardedTrainer
from gpuschedule_tpu_torch.parallel.train import ADAMW_WEIGHT_DECAY, Optimizer, lr_factor
from gpuschedule_tpu_torch.profiler import time_callable, time_steps

CELLS = {
    "dense": dict(model_name="transformer-large", batch_size=16, seq_len=512),
    "flash": dict(model_name="transformer-long", batch_size=2, seq_len=4096, flash_attn=True),
}
FORMS = ("foreach", "foreach_capturable", "fused_capturable")


def build_optimizer(trainer: ShardedTrainer, model: torch.nn.Module, form: str) -> Optimizer:
    """The trainer's adamw, schedule and clip, in ``form``."""
    params = list(model.parameters())
    capturable = form != "foreach"
    adamw = torch.optim.AdamW(
        params,
        lr=torch.tensor(trainer.learning_rate, device=params[0].device) if capturable
        else trainer.learning_rate,
        betas=(0.9, 0.999), eps=1e-8, weight_decay=ADAMW_WEIGHT_DECAY,
        capturable=capturable, fused=form == "fused_capturable",
        foreach=False if form == "fused_capturable" else True,
    )
    for group in adamw.param_groups:
        group["initial_lr"] = trainer.learning_rate
    opts = trainer.opt_kwargs
    sched = torch.optim.lr_scheduler.LambdaLR(adamw, partial(
        lr_factor, warmup_steps=opts["warmup_steps"], decay_steps=opts["decay_steps"]))
    return Optimizer(adamw, sched, opts["grad_clip"])


def update_kernels(update, calls: int = 3) -> tuple:
    """(device ms per call, [{kernel, ms, launches} per call]) of ``update``
    in a profiler window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            update()
        torch.cuda.synchronize()
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            ms, n = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3, n + 1)
    kernels = sorted(({"kernel": name[:100], "ms": ms / calls, "launches": n / calls}
                      for name, (ms, n) in by_name.items()), key=lambda k: -k["ms"])
    return sum(k["ms"] for k in kernels), kernels


def measure(cell: str, form: str) -> dict:
    trainer = ShardedTrainer(**CELLS[cell])
    state = trainer.init(seed=0)
    state.optimizer = build_optimizer(trainer, state.model, form)
    tokens = trainer.make_batch(seed=0)
    step = trainer._eager_step if form == "foreach" else trainer.step
    for _ in range(3):  # the captured forms: a warm-up, the capture and its replay, a replay
        state, _ = step(state, tokens)
    step_s, state = time_steps(step, state, tokens, iters=10, repeats=3)
    # the update alone, on the gradients of one eager forward and backward
    state.optimizer.zero_grad()
    trainer.loss(state.model(tokens), tokens).backward()
    update = state.optimizer.update
    update_ms = time_callable(update, iters=10, warmup=2, device=tokens.device) * 1e3
    device_ms, kernels = update_kernels(update)
    n_params = sum(p.numel() for p in state.model.parameters())
    del state, trainer, tokens
    torch.cuda.empty_cache()
    return {"cell": cell, "form": form, "params": n_params, "step_ms": step_s * 1e3,
            "update_ms": update_ms, "update_device_ms": device_ms,
            "update_kernels": kernels[:12]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("optimizer_costs: no CUDA device")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "torch": torch.__version__}), flush=True)
    for r in range(args.rounds):
        for cell in CELLS:
            for form in (FORMS if r % 2 == 0 else FORMS[::-1]):
                print(json.dumps({"round": r, **measure(cell, form)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
