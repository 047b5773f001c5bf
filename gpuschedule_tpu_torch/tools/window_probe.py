"""Which device records a ``torch.profiler`` window drops on the card, and when.

Each window of the probe launches, in this order: in the settled forms
one short spin, then a synchronize and a wait on the host; ``pads`` short
spins (``torch.cuda._sleep(100)``, ~1 µs each; none in the plain form,
the harness's ``PAD`` in the others; ``profiler.harness.device_window``'s
form is "padded"); the ``marker``, ``torch.cuda._sleep`` of the harness's ``MARKER_CYCLES``
(~20 µs); an ``aten mul`` (in-place ``mul_`` of 2**20 f32, a few µs);
``K1``, the flash forward through ctypes at (1, 256, 2, 32) bf16; and a
``graph replay`` of a captured ``neg_`` of 2**20 f32.  A series counts
the windows holding each kind in each form (:data:`FORMS`, in turns) and
the short spins the windows lost.  The series run in one process: alone on the card; after a
one-rank NCCL group is made and used in the process; while a child process
loads the card with matmuls; after the child has exited.  One JSON line
for the device, one a series:

    python -m gpuschedule_tpu_torch.tools.window_probe [--windows 50]

It needs the card and a free localhost port for the NCCL group's store.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

import torch

from gpuschedule_tpu_torch.profiler.harness import PAD

# a child process that keeps the card busy with matmuls for ``seconds``
LOAD = ("import sys, time, torch\n"
        "a = torch.randn(4096, 4096, device='cuda')\n"
        "t = time.time()\n"
        "while time.time() - t < float(sys.argv[1]):\n"
        "    a = a @ a\n"
        "    a = a / a.norm()\n"
        "    torch.cuda.synchronize()\n")
KINDS = ("marker", "aten mul", "K1", "graph replay")
# form -> (short spins before the marker, seconds waited after a first
# spin, None: no first spin): plain; padded (device_window's); settled
# and padded
FORMS = {"plain": (0, None), "padded": (PAD, None), "settled 0.1 s and padded": (PAD, 0.1),
         "settled 0.5 s and padded": (PAD, 0.5)}


class Probe:
    """The probe's tensors and its captured graph on the card."""

    def __init__(self):
        from gpuschedule_tpu_torch.ops.flash_attention import flash_fwd

        self.flash_fwd = flash_fwd
        self.x = torch.ones(1 << 20, device="cuda")
        self.z = torch.ones(1 << 20, device="cuda")
        self.q = torch.randn(1, 256, 2, 32, device="cuda").to(torch.bfloat16)
        self.flash_fwd(self.q, self.q, self.q, causal=True)  # builds the kernels
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.z.neg_()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.z.neg_()
        torch.cuda.synchronize()

    def window(self, pads: int, settle_s: Optional[float]) -> dict:
        """{kind: records of it} in one window after ``pads`` short spins,
        and the spins it holds before the marker; with ``settle_s``, one
        short spin, a synchronize and ``settle_s`` seconds come first."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from gpuschedule_tpu_torch.profiler.harness import MARKER_CYCLES, MARKER_US

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if settle_s is not None:
                torch.cuda._sleep(100)
                torch.cuda.synchronize()
                time.sleep(settle_s)
            for _ in range(pads):
                torch.cuda._sleep(100)
            torch.cuda._sleep(MARKER_CYCLES)
            self.x.mul_(1.0)
            self.flash_fwd(self.q, self.q, self.q, causal=True)
            self.graph.replay()
            torch.cuda.synchronize()
        got = dict.fromkeys(KINDS + ("pads",), 0)
        for evt in prof.events():
            if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
                continue
            if "spin" in evt.name:
                got["marker" if evt.time_range.elapsed_us() >= MARKER_US else "pads"] += 1
            for kind, part in (("aten mul", "AUnaryFunctor"), ("K1", "fwd_mma_kernel"),
                               ("graph replay", "neg_kernel")):
                got[kind] += part in evt.name
        return got

    def series(self, label: str, windows: int, forms: Sequence[str] = tuple(FORMS)) -> dict:
        """The windows of a series holding each kind of record in each of
        ``forms`` (keys of :data:`FORMS`, taken in turns), and the short
        spins a form's windows lost."""
        rows = {form: [] for form in forms}
        for _ in range(windows):
            for form in forms:
                pads, settle_s = FORMS[form]
                rows[form].append(self.window(pads, settle_s))
        out = {"series": label, "windows": windows, "holding": {}, "spins_lost": {}}
        for form, rs in rows.items():
            pads, settle_s = FORMS[form]
            lost = sorted(pads + (settle_s is not None) - r["pads"] for r in rs)
            out["holding"][form] = {k: sum(r[k] > 0 for r in rs) for k in KINDS}
            out["spins_lost"][form] = {"min": lost[0], "median": lost[len(lost) // 2],
                                       "max": lost[-1]}
        return out


def _nccl_group() -> None:
    """A one-rank NCCL group in this process, and one all-reduce on it."""
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    y = torch.ones(1 << 20, device="cuda")
    dist.all_reduce(y, op=dist.ReduceOp.AVG)
    torch.cuda.synchronize()


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpuschedule_tpu_torch.tools.window_probe")
    p.add_argument("--windows", type=int, default=50, help="windows a series")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("window_probe: no CUDA device; the probe is of the card's profiler",
              file=sys.stderr)
        return 1
    import torch.distributed as dist

    from gpuschedule_tpu_torch.cluster.cards import nvidia_smi_line

    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": nvidia_smi_line(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    probe = Probe()
    print(json.dumps(probe.series("alone on the card", args.windows)), flush=True)
    _nccl_group()
    print(json.dumps(probe.series("after a one-rank NCCL group in this process",
                                  args.windows)), flush=True)
    dist.destroy_process_group()
    load = subprocess.Popen([sys.executable, "-c", LOAD, "15"])
    try:
        time.sleep(6)  # the child has the card
        print(json.dumps(probe.series("while a child process loads the card", args.windows)),
              flush=True)
    finally:
        load.wait()
    print(json.dumps(probe.series("after the child exited", args.windows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
