#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gpuschedule_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. device — the card's name, and its name and power limit from nvidia-smi;
2. build — nvcc builds ``ops/csrc/*.cu`` from this checkout; each kernel's
   registers and spills from ``-Xptxas -v`` (the bf16 tensor-core kernels,
   in both output forms, must not spill at D = 32 and 64), and the count of
   ``HMMA`` instructions in each kernel's SASS from ``cuobjdump`` (the bf16
   forward, dq and dk/dv kernels must have some, in both output forms); the
   same for the probe kernels, with their
   static and dynamic shared memory (neither may spill, and the xᵀx kernel
   must have ``HMMA``);
3. parity — each CUDA kernel (forward, dq, dk/dv) against its plain PyTorch
   version on the same inputs: transformer-long's attention shape
   (B=2, S=4096, H=8, D=32, bf16, causal) and ragged shapes in bf16 (the
   tensor-core kernels) and f32 (the FMA kernels) at D = 32, 64, 96 and 128,
   causal and not, each output within FWD_TOL (out), LSE_TOL, GRAD_TOL of
   the plain gradient's largest entry, and TILE_RTOL in every 64-row tile
   (relative L2 per (b, h) tile); the flash op against the dense oracle in
   f32 and bf16; flash and dense transformer-long losses at init on a short
   sequence;
4. kernel times — CUDA events at the transformer-long shape, beside the plain
   versions, ``F.scaled_dot_product_attention`` (a yardstick the port never
   calls; for K2 and K3 together SDPA's flash backward, which returns dq, dk
   and dv in one call, from its forward's own out and lse) and the least
   time the card could take (``bound_ms``); for the
   bf16 forward, dq and dk/dv kernels also the device time per launch from
   a ``torch.profiler`` window, beside the event time;
5. flash train step — ``ShardedTrainer("transformer-long", batch_size=2,
   seq_len=4096, flash_attn=True)``, whose step on the card is a captured
   CUDA graph: 5 steps (a warm-up, the capture and its replay, 3 replays),
   ``time_steps(iters=5, repeats=3)``, one last step; the loss must be
   finite and fall, and the launch counters must show every kernel on the
   path (K1 >= 8, K2 >= 4, K3 >= 4 per step: 4 layers, remat recomputes
   each forward).  Then the same 5 steps from the same init through the
   trainer's eager path must give the same losses (within LOSS_RTOL); one
   replayed step's parameters must be those that the multi-tensor adamw
   with a host learning rate (the CPU's optimizer, held against optax
   there) makes from the same parameters, gradients and moments (within
   UPDATE_RTOL of the update, relative L2); 3 replays must make no host
   sync (``torch.cuda.set_sync_debug_mode``), the
   profiler window's launches of each kernel must equal the counters', and
   the device must be busy at least BUSY_MIN of an unprofiled step;
6. dense train step — transformer-large at b16 x S512, no kernel of ours;
7. probe parity — K5a (copy) and K5b (rows 0-7 of each tile's xᵀx) in both
   launch forms against their plain versions at n = 64, 4096, 37 and
   STAGES + 1 tiles of (8, 128) bf16 (STAGES: the kernels' ring depth, as
   the built library reports it): K5a exactly, K5b within one bf16 ulp;
8. probe sweeps — the four sweeps of the overhead probe
   (``gpuschedule_tpu_torch.tools.overhead_probe``), one JSON line per
   point and per slope; the launch counters must show both kernels; then
   the kernels at n = 4096 in both forms (CUDA events, the device time per
   launch from a profiler window, and the wrapper's host µs per call over
   1,000 unsynchronised calls: ``gpuschedule_tpu_torch/tools/probe_costs.py``)
   beside their plain versions, ``Tensor.copy_`` and ``torch.bmm``
   (yardsticks the port never calls) and the bound;
9. profile — ``profile_model("transformer-large", batch_size=16,
   seq_len=512)`` over ks 1-64 into a ``CurveCache``, which must reload
   with all seven ks, finite non-negative theta and a measured k = 1 point
   within 15% of phase 6's step, and the memory of its trainers given
   back; then ``capture_trace`` of 2 steps, whose file must exist; a
   ``{"profile": ...}`` line;
10. bench — ``python -m gpuschedule_tpu_torch.bench`` (dense, flash and
   long-context cells; transformer-xlong at b1 x S32768) in a subprocess:
   it must exit 0 with one line holding ``mfu``, a ``flash`` and a
   ``longctx`` sub-object (neither failed nor skipped), S = 32768, a finite
   loss, ``dense_feasible`` true or false, parity errors below 2e-2, and
   every kernel launched by both of its train steps; a ``{"bench": ...}``
   line.  Then K1, K2 and K3 against their plain versions at the
   long-context shape (B=1, S=32768, H=8, D=64, bf16, causal) within phase
   3's bounds, timed beside their bounds, SDPA's forward and SDPA's flash
   backward; and a profiler
   window of the long-context step (where its time goes, its busy share),
   whose launches of each kernel must be LONGCTX_PER_STEP, as the
   counters' are;
11. ring — the sequence-parallel path: (i) the f32-output forms of K1, K2
   and K3 (bf16 in, f32 out: the ring's chunk ops) against their plain
   versions at the ring's chunk shape for transformer-xlong at sp = 4
   (1, 8192, 8, 64), causal and full, and at two ragged shapes (D = 32 and
   96), within phase 3's bounds, each output f32 and, rounded to bf16, the
   bf16 form's to the bit; timed beside their bounds, plain versions and
   SDPA's forward; (ii) ``ring_flash_attention_in_process`` at sp = 4 on
   (1, 32768, 8, 64) bf16 causal, forward and backward, against the flash
   op (K1-K3 on the whole sequence) within phase 3's bounds, tile bound
   included, with exactly RING_PAIRS launches of each f32 form a pass (the
   4 diagonal and 6 past pairs; the 6 future pairs launch nothing), timed
   beside the flash op; (iii) the slice at full width: transformer-xlong
   b1 x S32768 (remat) with that ring as its attention core, forward and
   backward on one batch, against the flash model of the same parameters:
   the loss within LOSS_RTOL, every parameter's gradient within
   RING_GRAD_RTOL (relative L2), and RING_MODEL_LAUNCHES of the f32 forms
   (its main path: the counts are set to 0 just before it); (iv) the dense
   ring in process at sp = 4 on transformer-long's shape against the dense
   oracle; (v) the ``train`` CLI under ``torchrun`` on a one-rank NCCL mesh
   (``--ring-attn --flash-attn --sp 1``, 3 steps): a finite, falling loss.
   (v) checks only that the launcher, a one-rank NCCL group and
   ``init_device_mesh`` start: at sp = 1 the ring is the flash op and one
   rank runs the captured step, so it runs no ring code;
   a ``{"ring": ...}`` line;
12. zoo — the MoE and ResNet families at full width on the bench's batch
   (``zoo_phase``): transformer-moe and transformer-moe-top2 at b16 x S512
   and resnet-mid at b16 x 32x32, each a captured step (phase 5's checks:
   captured against eager losses within LOSS_RTOL, no host sync in 3
   replays, a finite falling loss), with its ms, tokens/s or samples/s,
   MFU, busy share and top device operations from a profiler window; each
   MoE's dispatch and combine einsums timed alone (their share of the
   step); transformer-moe under the flash op, whose path (the counts set
   to 0 just before it) must launch K1-K3, MOE_FLASH_PER_STEP a replayed
   step by the counters and by the profiler, its first loss within
   LOSS_RTOL of the dense-attention step's, and K1-K3 against their plain
   versions at the attention shape that step gives them (16, 512, 8, 32)
   bf16 causal, within phase 3's bounds; ``profile_model`` for
   resnet-mid and transformer-moe, whose curve entries must have phase 9's
   form; ``bench.child_main("resnet-mid")``, which must report samples/s;
   a ``{"zoo": ...}`` line;
13. data and checkpoints (``ckpt_phase``): (i) a token file written by the
   port's ``TokenFileDataset.write``, uint16 tokens of transformer-long's
   vocab, DATA_BATCHES batches of 2 x 4096; (ii) phase 5's trainer fed
   from it through ``prefetch_to_device``: 6 steps straight, then from the
   same init 3 steps, ``save_state``, ``restore_state`` into a fresh
   trainer and 3 more with the stream resumed at 3 (the phase's main path:
   the counts set to 0 just before the straight run): the resumed losses
   equal steps 4-6 within LOSS_RTOL (the parameters' relative L2 gap
   after step 6 printed), the restored trainer's replays launch K1 8, K2 4
   and K3 4 a step by the counters and by a profiler window, 3
   prefetch-fed replays make no host sync, the device is busy at least
   BUSY_MIN of the fed step, which is within STEP_RTOL of replays on one
   batch already on the card (the median over STEP_PAIRS pairs of 5-step
   blocks, resident then fed, of the fed block's time over the resident
   one's; phase 5's step printed beside them); (iii) the ``train`` CLI with ``--data --ckpt``, then ``--restore``
   (and a ``--seed 1`` restore under ``GSTPU_TRACE=1`` beside it): both
   exit 0, ``checkpoint`` and the sidecar's keys, ``resumed_at_step`` 3,
   the resumed first and last losses (ii)'s steps 4 and 6 within
   LOSS_RTOL, the drift warning, a spans line with a ``train.step`` a
   step; (iv) ``save_state`` and ``restore_state`` of transformer-large's
   state (b16 x S512, 2 steps) into a temporary directory on the TMPDIR
   filesystem and one in the checkout's (each's filesystem and free space
   logged, removed after): seconds, bytes, GB/s, each restored trainer's
   next loss within LOSS_RTOL of the unrestored one's, the memory given
   back; a ``{"ckpt": ...}`` line;
15. tensor parallelism with ep-over-tp (``tp_phase``, run after phase 13):
   K1-K3 at the shape a tp rank gives them (TP_SHAPE: transformer-long's 8
   heads over tp = 2, one row a dp rank) against their plain versions
   within phase 3's bounds, timed beside their bounds, SDPA's forward and
   SDPA's flash backward; then MESH_RANKS processes time-sliced on the one
   card (``torch.cuda.set_device(0)`` and a gloo group each: NCCL takes one
   rank a card, gloo stages CUDA tensors through host memory) build
   ``make_mesh(dp=2, tp=2)`` and run TP_CELLS at the zoo's full width,
   TP_STEPS steps each from seed 0 on the one-rank trainers' global
   batches: transformer-long b2 x S4096 under ``flash_attn`` (K1-K3 on a
   rank's 4 heads), transformer-moe b16 x S512 (4 of its 8 experts a rank,
   routed over the global batch) and transformer-large b16 x S512 (8
   heads, d_ff 3072 and vocab 4096 a rank).  Each first loss within
   LOSS_RTOL of the one-rank trainer's (phases 5, 12 and 6, from the same
   seed on the same batch), the losses finite and falling and the same on
   every rank, the parameters gathered over tp the same on every rank (one
   SHA-256 of their bytes), K1-K3 FLASH_PER_STEP a step on every rank by
   the counters; for the MoE, block 0's slots on each rank (given the
   one-rank model's input to it) those of the one-rank module, a flipped
   route named with its logit gap and allowed only at a near tie.  The
   step times carry TP_LABEL: they are not a tp speed.  A ``{"tp": ...}``
   line;
   Before the steps, on the dp column 0 ranks, each rank's gradients of
   one backward are held to the one-rank trainer's within TP_GRAD_RTOL,
   relative L2 (a split parameter slice by slice, a replicated one whole;
   the MoE's at block 0's module, given the one-rank model's input, where
   no route can flip): adam's update hides a gradient off by a constant
   factor, so no loss shows one;
16. the pipeline (``pp_phase``): K1-K3 at the shape a stage gives them
   (PP_SHAPE) against their plain versions and timed; then MESH_RANKS
   processes time-sliced on the card over gloo, as phase 15, build
   ``make_mesh(pp=2)`` (dp 2) and run PP_CELLS at the zoo's full width,
   PP_STEPS steps each from seed 0: transformer-large b16 x S512 M 4
   gpipe, transformer-moe b16 x S512 M 4 remat and transformer-long
   b4 x S4096 M 2 under ``flash_attn`` (one row a microbatch a dp rank).
   Each first loss within LOSS_RTOL of the one-rank computation of the
   same parameters (the whole model from the same seed, its blocks in
   sequence; for the MoE on each (microbatch, dp column) share, as the
   pipeline routes), the gradients of one backward within GRAD_TOL of its,
   the losses finite, falling and the same on every rank, K1-K3
   PP_FLASH_PER_STEP a step on every rank of the flash cell by the
   counters (the stage graphs' replays counted) and equal to a profiler
   window's.  The pipeline's own step captures each rank's stage compute
   in CUDA graphs (its exchanges eager between them): its PP_STEPS losses
   within LOSS_RTOL of an eager pipeline's from the same seed (bit-equal
   printed), one graph set a rank, the host's launch calls in one step
   (a profiler window's ``cudaLaunchKernel``, ``cudaGraphLaunch``, ...)
   fewer captured than eager on every rank, and each rank's peak memory
   printed beside the eager pipeline's.  Then, over the same ranks,
   the gathered-sequence sp path: SP_CELL on dp 2 x sp 2 (dense attention
   over k and v gathered over sp), its first loss within LOSS_RTOL of
   phase 5's, and ``profile_model(sp=2)`` measuring SP_KS into a
   ``model@sp2tp1`` entry.  The step times carry PP_LABEL.  A
   ``{"pp": ...}`` line;
17. the step over NCCL groups captured (``nccl_phase``): a process of its
   own joins a one-rank NCCL group, and NCCL_CELL's trainer takes its
   multi-rank capture path over the mesh (the gradient and loss
   all-reduces in the graph): NCCL_STEPS captured steps within LOSS_RTOL of
   as many eager steps, a profiler window of a replay, and a captured
   NCCL average replaying its kernel (NCCL launches nothing for a
   one-rank in-place sum, which is recorded).  The mechanism, not a
   multi-rank speed.  A ``{"nccl": ...}`` line;
18. ``entry()`` (``gpuschedule_tpu_torch/entry.py``): the flagship's
   logits on the card within FWD_TOL of the one-rank model's.  An
   ``{"entry": ...}`` line;
19. the tools (``tools_phase``): in the script's own process, which
   records the windows of ``tools.window_probe`` hold there (by then the
   process has shared the card with phases 10-17's processes, and its
   profiler windows drop device records: ROADMAP Queue 3); then, in a
   process of its own, the same probe and the port's ``tools.roofline``
   at MAIN_SHAPE, LONGCTX_SHAPE and TOOLS_SHAPE (executed FLOPs at least
   the function's, the function's bounds PERF.md's column to four
   places), K1-K3 at TOOLS_SHAPE (D = 128) against their plain
   versions within phase 3's bounds and timed beside their bounds and SDPA,
   ``tools.kernel_bench`` at its two shapes (every row timed, the flash
   rows through K1-K3 by the counters), ``tools.trace_flash`` (K1-K3 among
   the flash case's top device operations, each case's device ms within
   TRACE_RTOL of kernel_bench's) and ``roofline.fit_overhead`` of the
   measured flash fwd+bwd; the profiler windows each process took and lost
   and the phase's seconds printed.  A ``{"tools": ...}`` line;
20. the simulator (``sim_phase``): ``python -m gpuschedule_tpu_torch run``
   replays ``data/philly_10k.csv`` on the default v5p pod (8x8x4 = 256
   chips) under FIFO and DLAS, one process each, every job finishing, each
   replay's wall seconds beside the host CPU, the card's name and power
   limit; then ``run --policy optimus --online`` over 1,000 synthetic jobs
   on a v5e 16x16 pod in this process, each of the trace's four models
   profiled once on the card (``profile_model``, counted), one curve each,
   the profiling charge applied once a model, every job finished, each
   curve's k = 1 step within PROFILE_RTOL of a direct
   ``measure_step_time`` at the same batch and length (the profiled steps
   are dense: no flash launches); then the same trace offline from those
   curves twice, equal summaries.  A ``{"sim": ...}`` line;
21. topology and faults (``topology_phase``): seven commands of the port's
   CLI, all started together, one process each: ``run`` over
   ``data/philly_10k.csv`` on the v5p pod under Gandiva and under Themis;
   ``compare-topology`` over it with two random-scheme seeds (eight
   replays, the acceptance band, ``summary.json``, the CDFs and
   ``report.md``); ``run --net`` over 2,000 synthetic jobs on eight v5e
   4x4 pods (``net_reprices`` above 0) and the same without ``--net``
   (another summary); ``run --policy gandiva --faults`` over the Philly
   trace twice (faults, revocations and repairs above 0, the two
   ``jobs.csv`` byte-equal: the seed-split rule holds across processes).
   Every job finishes, and each summary line must be the JAX package's
   for the same command, character for character (TOPOLOGY_PINS, copied
   from the JAX package's runs: this script cannot import it); each
   command's wall seconds beside the host CPU, the card's name and power
   limit.  A ``{"topology": ...}`` line;
22. the event stream and resume (``events_phase``): ``run`` over
   ``data/philly_10k.csv`` on the v5p pod, four processes at once: DLAS
   with ``--events --attrib --perfetto --self-profile --history``, FIFO
   with ``--events --history`` into a store of its own (the two end in
   either order), DLAS with ``--accounting v2``, DLAS with
   ``--snapshot``s every 100,000 sim seconds; then the last snapshot
   resumed in a fresh process onto the stream with a crashed tail, beside
   ``report`` (in memory, ``--low-mem``, ``--selfprof``), ``compare`` and
   ``obs export``; then ``history trend`` and ``list``.  Every line, exit
   code and file (sha256) the JAX package's (EVENTS_* pins), the
   self-profile's phases and batches, the resumed run's files the
   uninterrupted run's bytes, and no process with a CUDA context; each
   command's wall seconds beside the host CPU, the card's name and power
   limit.  An ``{"events": ...}`` line;
23. sweeps and what-if (``sweeps_start``, ``sweeps_check``,
   ``sweeps_timed``): SWEEP_RUNS' nine processes start before phase 21's
   commands and are waited for after phase 22: ``faults`` at its defaults
   (eight policies, 200 jobs, MTBF 6 h, 8x8), ``tools.fault_sweep`` and
   ``tools.net_sweep`` over four workers, ``whatif`` on
   ``data/philly_10k.csv`` on v5p-256 under DLAS paused at WHATIF_AT with
   a pool of four (16 admits, a drain, a policy swap; ``--trace-out``,
   ``--history``, ``--prom``), a short DLAS replay's snapshot and
   ``whatif --resume`` from it, ``tools.report_smoke``,
   ``tools.attrib_smoke`` and ``tools.fault_chaos``: each line, file,
   stream and artifact (pooled ones against the JAX package's serial
   ones), whatif document (``canonical_document``), history row and
   ``--prom`` family held to the JAX package's (SWEEP_PINS, SWEEP_LINES),
   each fleet trace to its structure (``check_fleet``), no process with a
   CUDA context (SWEEP_NO_CUDA) but WHATIF_CUDA's: Optimus online on the
   card, whose pool then spawns, and a worker profiles the admitted
   model into the curve file.  Then, alone on the host,
   ``tools.engine_bench --sizes 10000`` and ``tools.whatif_bench``, each
   with its gate (the port's floors file; speed-up >= 1.5, p50 <= 1000
   ms).  Each command's wall seconds beside the host CPU, the card's name
   and power limit.  A ``{"sweeps": ...}`` line;
14. a ``{"train": ...}`` line, a ``{"kernels": [...]}`` line (the five
   kernels and the three f32 forms; K1-K3 with their launches on the MoE +
   flash path, phase 13's path and phases 15's and 16's flash cells too,
   and their times at phase 15's, 16's and 19's shapes), and last the
   ``{"ok": true, "device": {...}}`` line.

The bounds (``bound_ms``) are ``gpuschedule_tpu_torch/tools/roofline.py``'s
``attention_cost``, ``probe_cost`` and ``bound``.

Exits non-zero when CUDA is unavailable or the port cannot be imported
(``python3 chip_smoke.py`` in a directory with nothing else of the repo:
``cannot import the port``).
"""

from __future__ import annotations

import importlib
import importlib.util
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

FWD_TOL = 2e-2      # max abs error of the forward output (bench.py's bound)
GRAD_TOL = 2e-2     # max abs error of a gradient over the plain version's max
LSE_TOL = 1e-3      # max abs error of the f32 logsumexp rows
TILE_RTOL = 1e-2    # relative L2 error of any 64-row tile of an output or gradient
LOSS_RTOL = 2e-3    # flash vs dense loss at init (the JAX suite's bound); captured vs eager
UPDATE_RTOL = 1e-4  # a captured adamw update vs the multi-tensor one, over the update
BUSY_MIN = 0.8      # device busy share of an unprofiled flash step, the step captured

SOURCE = "gpuschedule_tpu_torch/ops/csrc/flash_attention.cu"
# wrapper -> (the kernel bf16 inputs launch, the kernel f32 inputs launch, replaces)
KERNELS = {
    "flash_fwd": ("fwd_mma_kernel", "fwd_kernel",
                  "gpuschedule_tpu/ops/flash_attention.py:98"),
    "flash_bwd_dq": ("dq_mma_kernel", "bwd_dq_kernel",
                     "gpuschedule_tpu/ops/flash_attention.py:155"),
    "flash_bwd_dkdv": ("dkdv_mma_kernel", "bwd_dkdv_kernel",
                       "gpuschedule_tpu/ops/flash_attention.py:202"),
}
TENSOR_CORE_KERNELS = ("fwd_mma_kernel", "dq_mma_kernel", "dkdv_mma_kernel")
NO_SPILL_HEAD_DIMS = (32, 64)  # transformer-long, transformer-xlong
TILE = 64  # rows of a kernel tile (BQ = BK)
MAIN_SHAPE = (2, 4096, 8, 32)  # transformer-long: d_model 256 / 8 heads, S = max_seq
LONGCTX_SHAPE = (1, 32768, 8, 64)  # transformer-xlong: d_model 512 / 8 heads, S = max_seq
LONGCTX_PER_STEP = {"flash_fwd": 12, "flash_bwd_dq": 6, "flash_bwd_dkdv": 6}  # 6 layers, remat
BENCH_TIMEOUT_S = 760  # above the bench's own budget, which bounds its children

# the ring's f32-output forms: counter name -> (kernel, replaces, the JAX call form)
F32_FORMS = {
    "flash_fwd_f32": ("fwd_mma_kernel", "gpuschedule_tpu/ops/flash_attention.py:98",
                      "flash_chunk_fwd :519"),
    "flash_bwd_dq_f32": ("dq_mma_kernel", "gpuschedule_tpu/ops/flash_attention.py:155",
                         "flash_chunk_bwd :539"),
    "flash_bwd_dkdv_f32": ("dkdv_mma_kernel", "gpuschedule_tpu/ops/flash_attention.py:202",
                           "flash_chunk_bwd :539"),
}
RING_SP = 4
RING_CHUNK_SHAPE = (1, 8192, 8, 64)  # transformer-xlong's S = 32768 over sp = 4
RING_PAIRS = RING_SP * (RING_SP + 1) // 2  # diagonal and past pairs of a causal pass
# 6 layers: a pass in each forward, again in each remat recompute, and in each backward
RING_MODEL_LAUNCHES = {"flash_fwd_f32": 120, "flash_bwd_dq_f32": 60, "flash_bwd_dkdv_f32": 60}
# ring vs flash model, each parameter's gradient, relative L2: 3x the largest
# sound reading on the card (1.0e-2, a query kernel's; median 3.2e-3), both
# models' gradients passing through bf16 activations rounded at other points
RING_GRAD_RTOL = 3e-2
CLI_TIMEOUT_S = 300

PROBE_SOURCE = "gpuschedule_tpu_torch/ops/csrc/overhead_probe.cu"
PROBE_KERNELS = {
    "probe_copy": ("probe_copy_kernel", "tools/overhead_probe.py:54"),
    "probe_matmul": ("probe_xtx_kernel", "tools/overhead_probe.py:58"),
}
PROBE_N, PROBE_BLOCK = 4096, 128  # the probe's largest grid, its tile width
PROFILE_KS = (1, 2, 4, 8, 16, 32, 64)
PROFILE_RTOL = 0.15  # profiled k = 1 step vs phase 6's step: same model, batch, S
# what profile_model may leave allocated: not a trainer (GBs of activations in
# its graph's pool), at most a library's workspace for a new stream
PROFILE_KEPT_MIB = 256
# phase 12: the zoo's MoE and ResNet families, (model, batch, seq) at the
# bench's batch and S; the CNN has no seq (its images are 32x32)
ZOO_CELLS = (("transformer-moe", 16, 512), ("transformer-moe-top2", 16, 512),
             ("resnet-mid", 16, None))
ZOO_PROFILE = ("resnet-mid", "transformer-moe")
MOE_FLASH_PER_STEP = {"flash_fwd": 4, "flash_bwd_dq": 4, "flash_bwd_dkdv": 4}  # 4 layers
# phase 13: data and checkpoints
FLASH_PER_STEP = {"flash_fwd": 8, "flash_bwd_dq": 4, "flash_bwd_dkdv": 4}  # 4 layers, remat
RESUME_CELL = ("transformer-long", 2, 4096)  # phase 5's model, batch and S
DATA_BATCHES = 20      # batches of RESUME_CELL's batch x S tokens in the phase's token file
STEP_RTOL = 0.03       # the prefetch-fed step vs the resident batch's: median of block pairs' ratios
STEP_PAIRS = 7         # pairs of 5-step blocks, a resident block then a fed one
CKPT_MODEL = ("transformer-large", 16, 512)  # the flagship's state for the cost
CKPT_BYTES_PER_PARAM = 12  # f32 parameters and adamw's two f32 moments
# phase 15: tensor parallelism with ep-over-tp, MESH_RANKS processes time-sliced
# on the one card (NCCL takes one rank a card; gloo stages CUDA tensors
# through host memory), the zoo's full widths on a dp 2 x tp 2 mesh
TP_STEPS = 3
TP_SHAPE = (1, 4096, 4, 32)  # transformer-long's 8 heads over tp 2, its batch of 2 over dp 2
# (model, global batch, seq, flash_attn)
TP_CELLS = (("transformer-long", 2, 4096, True), ("transformer-moe", 16, 512, False),
            ("transformer-large", 16, 512, False))
TP_LABEL = "4 ranks time-sliced on one card, gloo host-staged all-reduce: not a tp speed"
# a tp rank's gradient against the one-rank trainer's, relative L2 of each
# tensor (slice): tp's row-parallel sums round other than one product does,
# and attention's q and k gradients (ds = p·(dP - delta), a difference of
# near-equal sums) carry that noise up: 2.04e-2 on the card at transformer-
# long's last block (2.27e-2 max abs over the largest entry), where JAX's
# own gradients regrouped differ by 3.4% (tests/test_torch_pipeline_dist.py).
# A gradient off by a constant factor c is off by |c - 1| >= 50%.
TP_GRAD_RTOL = 5e-2
ROUTE_GAP = 1e-4  # a route may differ only where the top-k logits nearly tie
# phase 16: the pipeline (pp 2 x dp 2) on the same MESH_RANKS processes, time-sliced on the
# card over gloo, as phase 15; (model, batch, seq, microbatches, schedule, flash)
PP_STEPS = 3  # a warm-up, the stage graphs' capture and replay, a replay
PP_CELLS = (("transformer-large", 16, 512, 4, "gpipe", False),
            ("transformer-moe", 16, 512, 4, "remat", False),
            ("transformer-long", 4, 4096, 2, "gpipe", True))
PP_SHAPE = (1, 4096, 8, 32)  # transformer-long: one row a microbatch a dp rank, 8 heads
# K1-K3 a step on a rank of the flash cell: 2 layers a stage x 2 microbatches,
# the forward again in the blocks' remat recompute
PP_FLASH_PER_STEP = {"flash_fwd": 8, "flash_bwd_dq": 4, "flash_bwd_dkdv": 4}
MESH_RANKS = 4  # phases 15 and 16 share one spawn of ranks
MESH_TIMEOUT_S = 600
PP_LABEL = "4 ranks time-sliced on one card, gloo host-staged exchanges: not a pp speed"
# the gathered-sequence sp point: transformer-long b2 x S4096 dense attention
# on dp 2 x sp 2 over the same ranks, and its curve's measured points
SP_CELL = ("transformer-long", 2, 4096)
SP_KS = (2, 4)
# phase 17: the step captured over a one-rank NCCL group
NCCL_CELL = ("transformer-long", 2, 4096)
NCCL_STEPS = 5  # a warm-up, the capture and its replay, 3 replays
# phase 19: the tools (roofline, kernel_bench, trace_flash), in a process of their own
TOOLS_SHAPE = (2, 4096, 8, 128)  # kernel_bench's and trace_flash's wider head
# PERF.md's bound column (ms, K1-K3) at MAIN_SHAPE and LONGCTX_SHAPE, to four places
SECTION6_BOUNDS = {MAIN_SHAPE: (0.0174, 0.0261, 0.0348), LONGCTX_SHAPE: (1.1118, 1.6677, 2.2235)}
TRACE_RTOL = 0.15  # trace_flash's device ms vs kernel_bench's for the same case
# the window probe's series in the script's process and in phase 19's own
PROBE_WINDOWS = 15
PROBE_FORMS = ("plain", "padded", "settled 0.1 s and padded")
# phase 20: the simulator's run path
SIM_PHILLY = "data/philly_10k.csv"   # 10,000 jobs, replayed on the default v5p pod (8x8x4)
SIM_REPLAY_POLICIES = ("fifo", "dlas")
SIM_ONLINE = ("--policy", "optimus", "--cluster", "tpu-v5e", "--dims", "16x16",
              "--synthetic", "1000", "--seed", "42")
SIM_PROFILE = (2, 32)  # OptimusPolicy's profile_batch and profile_seq: what --online measures
SIM_TIMEOUT_S = 300
# phase 21: topology and faults; "{tmp}" is the phase's temporary directory
TOPOLOGY_FAULTS = "mtbf=86400,repair=3600,ckpt=1800"
TOPOLOGY_NET_WORLD = ("--cluster", "tpu-v5e", "--dims", "4x4", "--pods", "8",
                      "--synthetic", "2000", "--seed", "42")
TOPOLOGY_RUNS = {
    "gandiva": ("run", "--cluster", "tpu-v5p", "--philly", SIM_PHILLY, "--policy", "gandiva"),
    "themis": ("run", "--cluster", "tpu-v5p", "--philly", SIM_PHILLY, "--policy", "themis"),
    "compare-topology": ("compare-topology", "--philly", SIM_PHILLY, "--seeds", "2",
                         "--out", "{tmp}/topology"),
    "net": ("run", *TOPOLOGY_NET_WORLD, "--net", "--out", "{tmp}/net"),
    "no-net": ("run", *TOPOLOGY_NET_WORLD),
    "faults-1": ("run", "--cluster", "tpu-v5p", "--philly", SIM_PHILLY, "--policy", "gandiva",
                 "--faults", TOPOLOGY_FAULTS, "--out", "{tmp}/faults-1"),
    "faults-2": ("run", "--cluster", "tpu-v5p", "--philly", SIM_PHILLY, "--policy", "gandiva",
                 "--faults", TOPOLOGY_FAULTS, "--out", "{tmp}/faults-2"),
}
TOPOLOGY_REPLAYS = ("gpu-consolidated", "gpu-random-s0", "gpu-random-s1", "gpu-topology",
                    "tpu-v5e", "tpu-v5p", "tpu-v5p-2pod", "tpu-v5p-2pod-net")
TOPOLOGY_TIMEOUT_S = 400
# The JAX package's stdout line for each command above (both faults runs
# print the "faults" line), as ``python -m gpuschedule_tpu`` printed it on
# the CPU; tests/test_torch_faults.py recomputes the "net" line from the
# JAX package.
TOPOLOGY_PINS = {
    'gandiva': (
        '{"arrivals": 10000.0, "avg_jct": 4135.120928031582, "goodput_lost_chip_s": 0.0, "goo'
        'dput_restart_overhead_chip_s": 8290468.963565073, "goodput_total_chip_s": 187690689.'
        '38884622, "goodput_useful_chip_s": 179400220.42528114, "grows": 8522.0, "makespan": '
        '801273.5281441035, "max_slowdown": 514.8603948266858, "mean_utilization": 0.50472761'
        '34650939, "migrations": 989.0, "num_done": 6897, "num_failed": 1191, "num_finished":'
        ' 10000, "num_killed": 1912, "num_rejected": 0, "num_unfinished": 0, "p95_queueing_de'
        'lay": 220.7860000000801, "p95_slowdown": 2.304356183746152, "preemptions": 63370.0}'
    ),
    'themis': (
        '{"arrivals": 10000.0, "avg_jct": 8831.446231170696, "goodput_lost_chip_s": 0.0, "goo'
        'dput_restart_overhead_chip_s": 0.0, "goodput_total_chip_s": 161978684.85000002, "goo'
        'dput_useful_chip_s": 161978684.85000002, "makespan": 1902793.0648753555, "max_slowdo'
        'wn": 198.27288979696038, "mean_utilization": 0.332507876239062, "num_done": 6897, "n'
        'um_failed": 1191, "num_finished": 10000, "num_killed": 1912, "num_rejected": 0, "num'
        '_unfinished": 0, "p95_queueing_delay": 12052.630000000005, "p95_slowdown": 2.8243894'
        '395474176, "preemptions": 13285.0}'
    ),
    'compare-topology': (
        '{"acceptance": {"jct_delta_pct": 478.170770445228, "makespan_delta_pct": 9.868474499'
        '127357, "threshold_pct": 5.0, "within_5pct": false}, "contention": {"jct_ratio_net_o'
        'ver_static": null, "mean_link_utilization": {"core": 0.0017460131054161181, "uplink/'
        'pod0": 0.0006504855270451638, "uplink/pod1": 0.00022252102566289888}, "multislice_jo'
        'bs": 0, "net_reprices": 0, "oversubscription": 4.0}, "dcn_vs_ici": {"jct_ratio_2pod_'
        'over_1pod": null, "multislice_jobs": 0}, "gpu-consolidated": {"arrivals": 10000.0, "'
        'avg_jct": 44341.29552204446, "goodput_lost_chip_s": 0.0, "goodput_restart_overhead_c'
        'hip_s": 0.0, "goodput_total_chip_s": 191160538.0242222, "goodput_useful_chip_s": 191'
        '160538.0242222, "makespan": 1680076.9405555553, "max_slowdown": 3292.3177814814803, '
        '"mean_utilization": 0.4444563422257284, "num_done": 6897, "num_failed": 1191, "num_f'
        'inished": 10000, "num_killed": 1912, "num_rejected": 0, "num_unfinished": 0, "p95_qu'
        'eueing_delay": 83696.14000000025, "p95_slowdown": 926.424323834416}, "gpu-random-mea'
        'n": {"avg_jct": 55218.11181462224, "makespan": 1904534.2791666668, "seeds": 2}, "gpu'
        '-random-s0": {"arrivals": 10000.0, "avg_jct": 55815.309443599996, "goodput_lost_chip'
        '_s": 0.0, "goodput_restart_overhead_chip_s": 0.0, "goodput_total_chip_s": 202852680.'
        '59577778, "goodput_useful_chip_s": 202852680.59577778, "makespan": 1904818.119333333'
        '3, "max_slowdown": 4196.635429629633, "mean_utilization": 0.4159941967869267, "num_d'
        'one": 6897, "num_failed": 1191, "num_finished": 10000, "num_killed": 1912, "num_reje'
        'cted": 0, "num_unfinished": 0, "p95_queueing_delay": 104972.92033333331, "p95_slowdo'
        'wn": 1192.957734820179}, "gpu-random-s1": {"arrivals": 10000.0, "avg_jct": 54620.914'
        '185644484, "goodput_lost_chip_s": 0.0, "goodput_restart_overhead_chip_s": 0.0, "good'
        'put_total_chip_s": 202446777.5973333, "goodput_useful_chip_s": 202446777.5973333, "m'
        'akespan": 1904250.439, "max_slowdown": 4136.57506666667, "mean_utilization": 0.41528'
        '55679029638, "num_done": 6897, "num_failed": 1191, "num_finished": 10000, "num_kille'
        'd": 1912, "num_rejected": 0, "num_unfinished": 0, "p95_queueing_delay": 103396.79966'
        '666666, "p95_slowdown": 1162.1242876312258}, "gpu-topology": {"arrivals": 10000.0, "'
        'avg_jct": 431467.5832676665, "goodput_lost_chip_s": 0.0, "goodput_restart_overhead_c'
        'hip_s": 0.0, "goodput_total_chip_s": 169092415.49533337, "goodput_useful_chip_s": 16'
        '9092415.49533337, "makespan": 2149287.5005555553, "max_slowdown": 30987.80818518517,'
        ' "mean_utilization": 0.3073191687282013, "num_done": 6897, "num_failed": 1191, "num_'
        'finished": 10000, "num_killed": 1912, "num_rejected": 0, "num_unfinished": 0, "p95_q'
        'ueueing_delay": 898892.3782222217, "p95_slowdown": 9989.507053674044}, "tpu-v5e": {"'
        'arrivals": 10000.0, "avg_jct": 368085.1379626, "goodput_lost_chip_s": 0.0, "goodput_'
        'restart_overhead_chip_s": 0.0, "goodput_total_chip_s": 161978684.84999996, "goodput_'
        'useful_chip_s": 161978684.84999996, "makespan": 2062905.7989999996, "max_slowdown": '
        '28168.114499999985, "mean_utilization": 0.3067174652386116, "num_done": 6897, "num_f'
        'ailed": 1191, "num_finished": 10000, "num_killed": 1912, "num_rejected": 0, "num_unf'
        'inished": 0, "p95_queueing_delay": 813537.0819999997, "p95_slowdown": 8553.963724589'
        '545}, "tpu-v5p": {"arrivals": 10000.0, "avg_jct": 256368.40994519982, "goodput_lost_'
        'chip_s": 0.0, "goodput_restart_overhead_chip_s": 0.0, "goodput_total_chip_s": 161978'
        '684.84999996, "goodput_useful_chip_s": 161978684.84999996, "makespan": 1845874.90499'
        '99993, "max_slowdown": 20976.445866666632, "mean_utilization": 0.34278012880581077, '
        '"num_done": 6897, "num_failed": 1191, "num_finished": 10000, "num_killed": 1912, "nu'
        'm_rejected": 0, "num_unfinished": 0, "p95_queueing_delay": 597916.654, "p95_slowdown'
        '": 5748.442396736725}, "tpu-v5p-2pod": {"arrivals": 10000.0, "avg_jct": 4762.2803997'
        ', "goodput_lost_chip_s": 0.0, "goodput_restart_overhead_chip_s": 0.0, "goodput_total'
        '_chip_s": 161978684.85000002, "goodput_useful_chip_s": 161978684.85000002, "makespan'
        '": 1449540.638, "max_slowdown": 76.88179999999896, "mean_utilization": 0.21825163817'
        '70154, "num_done": 6897, "num_failed": 1191, "num_finished": 10000, "num_killed": 19'
        '12, "num_rejected": 0, "num_unfinished": 0, "p95_queueing_delay": 0.0, "p95_slowdown'
        '": 1.0000000000002145}, "tpu-v5p-2pod-net": {"arrivals": 10000.0, "avg_jct": 4762.28'
        '03997, "goodput_lost_chip_s": 0.0, "goodput_restart_overhead_chip_s": 0.0, "goodput_'
        'total_chip_s": 161978684.85000002, "goodput_useful_chip_s": 161978684.85000002, "mak'
        'espan": 1449540.638, "max_slowdown": 76.88179999999896, "mean_utilization": 0.218251'
        '6381770154, "num_done": 6897, "num_failed": 1191, "num_finished": 10000, "num_killed'
        '": 1912, "num_rejected": 0, "num_unfinished": 0, "p95_queueing_delay": 0.0, "p95_slo'
        'wdown": 1.0000000000002145}}'
    ),
    'net': (
        '{"arrivals": 2000.0, "avg_jct": 175713.9540733729, "goodput_lost_chip_s": 0.0, "good'
        'put_restart_overhead_chip_s": 0.0, "goodput_total_chip_s": 43904688.25049581, "goodp'
        'ut_useful_chip_s": 43904688.25049581, "makespan": 506659.11244535167, "max_slowdown"'
        ': 6014.361720848327, "mean_utilization": 0.6769943903732617, "net_reprices": 1535.0,'
        ' "num_done": 2000, "num_failed": 0, "num_finished": 2000, "num_killed": 0, "num_reje'
        'cted": 0, "num_unfinished": 0, "p95_queueing_delay": 329821.0714169774, "p95_slowdow'
        'n": 741.2345711996655}'
    ),
    'no-net': (
        '{"arrivals": 2000.0, "avg_jct": 178205.2932848283, "goodput_lost_chip_s": 0.0, "good'
        'put_restart_overhead_chip_s": 0.0, "goodput_total_chip_s": 43871300.27011449, "goodp'
        'ut_useful_chip_s": 43871300.27011449, "makespan": 514466.13160818577, "max_slowdown"'
        ': 6135.4310214959505, "mean_utilization": 0.6662139882539474, "num_done": 2000, "num'
        '_failed": 0, "num_finished": 2000, "num_killed": 0, "num_rejected": 0, "num_unfinish'
        'ed": 0, "p95_queueing_delay": 336937.5837547229, "p95_slowdown": 754.609081233344}'
    ),
    'faults': (
        '{"arrivals": 10000.0, "avg_jct": 10227.372853725221, "fault_revocations": 2503.0, "f'
        'aults": 4763.0, "faults_mtbf": 4763.0, "goodput_lost_chip_s": 41164600.651230134, "g'
        'oodput_restart_overhead_chip_s": 18188056.67532588, "goodput_total_chip_s": 22244694'
        '9.7320728, "goodput_useful_chip_s": 163094292.4055168, "grows": 517.0, "makespan": 1'
        '628140.1104805183, "max_slowdown": 9043.590511215585, "mean_utilization": 0.53369694'
        '15577206, "migrations": 4831.0, "num_done": 6897, "num_failed": 1191, "num_finished"'
        ': 10000, "num_killed": 1912, "num_rejected": 0, "num_unfinished": 0, "p95_queueing_d'
        'elay": 262.0355165824294, "p95_slowdown": 3.2980999999990064, "preemptions": 116101.'
        '0, "repairs": 4755.0}'
    ),
}
# phase 22: the event stream and resume; "{tmp}" is the phase's temporary directory
EVENTS_WORLD = ("--cluster", "tpu-v5p", "--philly", SIM_PHILLY)
EVENTS_SNAPSHOT_EVERY = "100000"  # sim seconds: 16 snapshots in the DLAS replay's 1.69e6 s
EVENTS_REPLAYS = {
    "dlas": ("run", "--policy", "dlas", *EVENTS_WORLD, "--events", "--attrib",
             "--perfetto", "{tmp}/dlas.trace.json", "--self-profile", "{tmp}/dlas.prof.json",
             "--history", "{tmp}/h.db", "--out", "{tmp}/dlas"),
    # a store of its own: DLAS's runs at the same time, and the rows of a
    # shared store would fall in the order the two processes end
    "fifo": ("run", "--policy", "fifo", *EVENTS_WORLD, "--events", "--history",
             "{tmp}/h_fifo.db", "--out", "{tmp}/fifo"),
    "v2": ("run", "--policy", "dlas", *EVENTS_WORLD, "--accounting", "v2", "--out", "{tmp}/v2"),
    "snap": ("run", "--policy", "dlas", *EVENTS_WORLD, "--events", "--snapshot", "{tmp}/s.pkl",
             "--snapshot-every", EVENTS_SNAPSHOT_EVERY, "--out", "{tmp}/snap"),
}
EVENTS_RESUME = ("run", "--resume", "{tmp}/s.pkl", "--events", "--out", "{tmp}/resumed")
EVENTS_READERS = {
    "report": ("report", "--events", "{tmp}/dlas/events.jsonl", "--json", "{tmp}/report.json",
               "--out", "{tmp}/report.html"),
    "report-low-mem": ("report", "--low-mem", "--events", "{tmp}/dlas/events.jsonl",
                       "--json", "{tmp}/report_lm.json", "--out", "{tmp}/report_lm.html"),
    "report-selfprof": ("report", "--events", "{tmp}/dlas/events.jsonl", "--selfprof",
                        "{tmp}/dlas.prof.json", "--out", "{tmp}/report_sp.html"),
    "compare": ("compare", "{tmp}/fifo/events.jsonl", "{tmp}/dlas/events.jsonl",
                "--json", "{tmp}/compare.json", "--history", "{tmp}/h.db"),
    "export": ("obs", "export", "--events", "{tmp}/dlas/events.jsonl",
               "--out", "{tmp}/export.json"),
}
EVENTS_HISTORY = {
    "trend": ("history", "trend", "--store", "{tmp}/h.db", "--metric", "avg_jct"),
    "list": ("history", "list", "--store", "{tmp}/h.db"),
    "list-fifo": ("history", "list", "--store", "{tmp}/h_fifo.db"),
}
EVENTS_TIMEOUT_S = 400
# A phase-22 process: the port's CLI, then whether it made a CUDA context
# (it must not: the phase adds no process that shares the card).
CLI_NO_CUDA = ("import sys, torch\n"
               "from gpuschedule_tpu_torch.cli import main\n"
               "rc = main(sys.argv[1:])\n"
               "print(f'cuda_initialized={torch.cuda.is_initialized()}', file=sys.stderr)\n"
               "sys.exit(rc)")
# What the JAX package printed and wrote for the commands above, as
# ``python -m gpuschedule_tpu.cli`` ran them on the CPU (sha256 of each
# file; the in-memory and the --low-mem report JSON differ in the JAX
# package itself, in the last digits of two means, so each has its pin);
# tests/test_torch_obs.py recomputes EVENTS_HEADER from the JAX package.
EVENTS_PINS = {
    'dlas': (
        '{"arrivals": 10000.0, "avg_jct": 8667.20738252103, "delay_admission_s": 65792.38588844'
        '816, "delay_capacity_s": 55938.296780569355, "delay_policy_preempt_s": 39133293.184541'
        '374, "delay_work_s": 47417049.95799994, "goodput_lost_chip_s": 0.0, "goodput_restart_o'
        'verhead_chip_s": 0.0, "goodput_total_chip_s": 161978684.85000002, "goodput_useful_chip'
        '_s": 161978684.85000002, "makespan": 1691376.2835997785, "max_slowdown": 47.8855294731'
        '1512, "mean_utilization": 0.374091350239738, "num_done": 6897, "num_failed": 1191, "nu'
        'm_finished": 10000, "num_killed": 1912, "num_rejected": 0, "num_unfinished": 0, "p95_q'
        'ueueing_delay": 0.0, "p95_slowdown": 3.29962887226621, "preemptions": 40967.0}'
    ),
    'fifo': (
        '{"arrivals": 10000.0, "avg_jct": 256368.40994519982, "goodput_lost_chip_s": 0.0, "good'
        'put_restart_overhead_chip_s": 0.0, "goodput_total_chip_s": 161978684.84999996, "goodpu'
        't_useful_chip_s": 161978684.84999996, "makespan": 1845874.9049999993, "max_slowdown": '
        '20976.445866666632, "mean_utilization": 0.34278012880581077, "num_done": 6897, "num_fa'
        'iled": 1191, "num_finished": 10000, "num_killed": 1912, "num_rejected": 0, "num_unfini'
        'shed": 0, "p95_queueing_delay": 597916.654, "p95_slowdown": 5748.442396736725}'
    ),
    'v2': (
        '{"arrivals": 10000.0, "avg_jct": 8667.20738252103, "goodput_lost_chip_s": 0.0, "goodpu'
        't_restart_overhead_chip_s": 0.0, "goodput_total_chip_s": 161978684.85000002, "goodput_'
        'useful_chip_s": 161978684.85000002, "makespan": 1691376.2835997785, "max_slowdown": 47'
        '.88552947311512, "mean_utilization": 0.3740913502397377, "num_done": 6897, "num_failed'
        '": 1191, "num_finished": 10000, "num_killed": 1912, "num_rejected": 0, "num_unfinished'
        '": 0, "p95_queueing_delay": 0.0, "p95_slowdown": 3.29962887226621, "preemptions": 4096'
        '7.0}'
    ),
    'snap': (
        '{"arrivals": 10000.0, "avg_jct": 8667.20738252103, "goodput_lost_chip_s": 0.0, "goodpu'
        't_restart_overhead_chip_s": 0.0, "goodput_total_chip_s": 161978684.85000002, "goodput_'
        'useful_chip_s": 161978684.85000002, "makespan": 1691376.2835997785, "max_slowdown": 47'
        '.88552947311512, "mean_utilization": 0.374091350239738, "num_done": 6897, "num_failed"'
        ': 1191, "num_finished": 10000, "num_killed": 1912, "num_rejected": 0, "num_unfinished"'
        ': 0, "p95_queueing_delay": 0.0, "p95_slowdown": 3.29962887226621, "preemptions": 40967'
        '.0}'
    ),
}
EVENTS_HEADER = ('{"schema": 1, "run_id": "dlas-s0-20551f6eb60e", "seed": 0, "policy": "dlas", '
                 '"config_hash": "20551f6eb60e", "total_chips": 256}')
EVENTS_SHA256 = {
    'dlas/events.jsonl': '07707f268fc0e27352aa2595bd2aecdf8ed23fd8df7c51c89f55e6e03e958620',
    'fifo/events.jsonl': 'c2cfb550c4e92a5a5513ef283905b3c7cbc65dfab5465c4e9b7b1c3a0e0b25ea',
    'snap/events.jsonl': '8073052403c217e513b8eb4c18d34a16619088da35cc92b6fb92b9251538736f',
    'dlas.trace.json': 'b961072ce99a9f3ddad90ca1058cdd776cbcce498708da97144f85b97dbdcd5e',
    'report.html': '1327b4144c0429dc2d10e981007fbd33c68e86c0c163e4d745cfaea767765205',
    'report.json': '5b51abbf21cbc54215b86b3af7998a5ec8140674ee4f7753ee530e4af13a3a41',
    'report_lm.json': '7a70fdbc7843445d5cd486cbda2ce04d408e0048e5d709f19e7d5e5da003b828',
    'compare.json': '0eaf8c8293b8b5590141422371181022c3f97d1a107aba3b4eee759be1bb797b',
}
EVENTS_REPORT = {'events': 111934, 'jobs': 10000, 'max_progress_drift': 1.5379980729880451e-12}
EVENTS_PROFILE = {"batches": 71178,
                  "phases": ("advance", "analytics", "event_apply", "fault_dispatch",
                             "ledger_sync", "metrics_emit", "net_resolve", "other",
                             "policy_schedule")}
EVENTS_COMPARE_RC = 0
EVENTS_TREND = (
    'seq  kind     policy  label  run                   avg_jct  d%(avg_jct)\n---  ---'
    '----  ------  -----  --------------------  -------  -----------\n1    run      dl'
    'as    -      dlas-s0-20551f6eb60e  8667.21  -\n2    compare  fifo    -      fifo-'
    's0-20551f6eb60e  256368   +2857.9\n3    compare  dlas    -      dlas-s0-20551f6eb'
    '60e  8667.21  -96.6'
)
EVENTS_LIST = (
    '{"config_hash": "20551f6eb60e", "kind": "run", "label": "", "policy": "dlas", "r'
    'un_id": "dlas-s0-20551f6eb60e", "seed": 0, "seq": 1}\n{"config_hash": "20551f6eb6'
    '0e", "kind": "compare", "label": "", "policy": "fifo", "run_id": "fifo-s0-20551f'
    '6eb60e", "seed": 0, "seq": 2}\n{"config_hash": "20551f6eb60e", "kind": "compare",'
    ' "label": "", "policy": "dlas", "run_id": "dlas-s0-20551f6eb60e", "seed": 0, "se'
    'q": 3}'
)
EVENTS_LIST_FIFO = (
    '{"config_hash": "20551f6eb60e", "kind": "run", "label": "", "policy": "fifo", "r'
    'un_id": "fifo-s0-20551f6eb60e", "seed": 0, "seq": 1}'
)
# phase 23: sweeps and what-if; "{tmp}" is the phase's temporary directory.
# Each entry is (kind, arguments): "cli" runs the port's CLI, "tool" a module of
# gpuschedule_tpu_torch.tools as ``python -m`` would, "chain" CLI commands one
# after the other in one process, split at "--then".
SWEEP_MTBFS = "inf,604800,86400,43200"  # the fault-free arm, a week, a day, half a day
WHATIF_WORLD = ("--policy", "dlas", "--cluster", "tpu-v5p", "--philly", SIM_PHILLY)
WHATIF_AT = 300000.0  # mid-trace: 81 jobs running, 38 queued under DLAS (arrivals end ~673,000 s)
WHATIF_QUERIES = (
    *(arg for i in range(16) for arg in (
        "--admit", f"chips=16,duration=7200,job_id=wifq{i},at={WHATIF_AT + 1800 * i:.0f}")),
    "--drain", f"pod=0,at={WHATIF_AT + 20000:.0f},duration=3600", "--swap-policy", "fifo")
WHATIF_POOL = 4
SWEEP_RUNS = {  # started beside phase 21's commands
    "faults": ("cli", "faults", "--events", "{tmp}/fev", "--out", "{tmp}/faults.json"),
    "fault_sweep": ("tool", "fault_sweep", "--mtbfs", SWEEP_MTBFS, "--workers", "4",
                    "--trace", "{tmp}/fs.trace.json", "--out", "{tmp}/fs.json"),
    "net_sweep": ("tool", "net_sweep", "--workers", "4", "--trace", "{tmp}/ns.trace.json",
                  "--out", "{tmp}/ns.json"),
    "whatif": ("cli", "whatif", *WHATIF_WORLD, "--at", f"{WHATIF_AT:.0f}", *WHATIF_QUERIES,
               "--pool", str(WHATIF_POOL), "--trace-out", "{tmp}/wi.trace.json",
               "--history", "{tmp}/wi.db", "--prom", "{tmp}/wi.prom", "--out", "{tmp}/wi.json"),
    # a short DLAS replay that snapshots once, at 200,000 s, then the
    # mirror taken from that snapshot
    "whatif-resume": ("chain", "run", "--policy", "dlas", "--cluster", "tpu-v5e", "--dims", "8x8",
                      "--synthetic", "800", "--seed", "42", "--snapshot", "{tmp}/w.pkl",
                      "--snapshot-every", "200000", "--then", "whatif", "--resume", "{tmp}/w.pkl",
                      "--at", "200000", "--admit", "chips=8,duration=3600,at=201000",
                      "--drain", "pod=0,at=205000,duration=7200", "--swap-policy", "srtf",
                      "--out", "{tmp}/wr.json"),
    "report_smoke": ("tool", "report_smoke"),
    "attrib_smoke": ("tool", "attrib_smoke"),
    # its 40 cells over four workers (the document is the serial one's):
    # one Gandiva cell takes 155 s alone on an 8-core host (PERF.md)
    "fault_chaos": ("tool", "fault_chaos", "--workers", "4"),
}
# Optimus profiling online on the card in the whatif parent, then a pooled
# admit of a model the mirror has not profiled: the pool spawns its
# workers (a forked child cannot use CUDA), and the worker profiles the
# model on the card into the curve file.
WHATIF_CUDA_MODEL = "transformer-long"
WHATIF_CUDA = ("cli", "whatif", "--policy", "optimus", "--curves", "{tmp}/wc.json", "--online",
               "--cluster", "tpu-v5e", "--dims", "4x4", "--pods", "2", "--synthetic", "12",
               "--seed", "42", "--at", "3600", "--pool", "2",
               "--admit", f"chips=4,duration=3600,model={WHATIF_CUDA_MODEL}",
               "--trace-out", "{tmp}/wc.trace.json", "--out", "{tmp}/wc.out.json")
SWEEP_TIMED = {  # after phase 22, one at a time, alone on the host
    "engine_bench": ("tool", "engine_bench", "--sizes", "10000", "--out", "{tmp}/eb.json"),
    "whatif_bench": ("tool", "whatif_bench", "--out", "{tmp}/wb.json"),
}
SWEEP_TIMEOUT_S = 600
# What the JAX package printed and wrote for SWEEP_RUNS' commands, as
# ``python -m gpuschedule_tpu.cli`` and ``tools/*.py`` ran them on the CPU
# (whatif with --pool 0, the sweeps with --workers 1: the pooled outputs
# are held to the serial ones), the phase's temporary directory written
# "{tmp}": sha256 of the faults line and of each file; of the whatif
# documents without their latency and pool size (whatif_canonical_sha),
# the history rows without time stamp and latency (whatif_history), the
# --prom lines without latency buckets and pool counters (prom_families);
# and the smokes' lines without their temporary directory.
# tests/test_torch_whatif.py recomputes the "ns.json" pin from the JAX package.
SWEEP_PINS = {
    'faults line': '962522b292410920bbb21e2df269baa7568b60b6dd1c3bf09f37e41091db629e',
    'faults.json': '65c3c02008635a91eb99a35cd238fd5e2315afba0d21e1d15bcad30e44ada421',
    'fifo.events.jsonl': 'c647f231350915e1c9e4bfb0d3ac42cba317b9995fee9be4415f333b2c653205',
    'themis.events.jsonl': '00055a71f892c5c9e290fcfa1e2ed2728d4b62530e64673ba8901b818b3d7186',
    'gandiva.events.jsonl': 'acf836c309cc991a739a720d823fcc150336a379f914ce7f9768986774ef7f30',
    'fifo-backfill.events.jsonl': 'f1e2e273b1f4db0f26e6730ae49e9c16520a44208308b4c86fd1dc8406c99de3',
    'srtf-ckpt.events.jsonl': 'ca4b993f9d4ebc6f38dbf03bc56f81b8cec69087e0da32aeee1a7c5b514edb35',
    'srtf.events.jsonl': 'b59a586e7be6e915ed2cd4b6f8174cd2a3ce76cfe1cf05631d907407668562d7',
    'optimus.events.jsonl': '8210b2f4b09a1648188511a746b563b64057ea4adc36da34a89f61c688549036',
    'dlas.events.jsonl': '0fbbc2d13173d806d9ddfd479dd534cba9ee2fa7d19cf904f438a855b9629dd4',
    'fs.json': 'c9ad9227a8447e73c7ddd31ca51322517ab7042205fbd2400347614740b3f60a',
    'ns.json': '677541474158699670cac42268da62869b775a46e6a892f7b4fddf38757248e9',
    'whatif canonical': '93a723b11f1349da217a464ae7e9d98fb7579be987de7eab9c8d0b63a282a291',
    'whatif history': 'e5b64c1445ae849862a2696e1c32795d6d8938e97148adbd80ec57903c735e02',
    'whatif prom': 'fc7761e9bd0c3bb82376c079431c398903b956d39180ed1278f539953f93836d',
    'whatif-resume canonical': '607717dae708325b212a1603637b2a645a60df1b7f0a26753a319bced115512c',
}
SWEEP_LINES = {
    'report_smoke': {'events_a': 6366, 'ok': True, 'report_bytes': 138515, 'self_compare_rc': 0, 'tightened_compare_rc': 1},
    'attrib_smoke': {'delay_by_cause': {'admission': 38665366.16, 'fault-outage': 12062100.869, 'net-degraded': 11515.309, 'overhead': 2637.782, 'policy-preempt': 49561041.052, 'work': 1261587.066}, 'events': 27384, 'max_jct_residual': 4.656612873077393e-10, 'max_wait_residual': 4.656612873077393e-10, 'mean_phys_occupancy': 0.1173, 'ok': True, 'report_bytes': 149866, 'samples': 3224},
    'fault_chaos': {'cells': 40, 'configs': 5, 'failed_cells': 0},
}
# A phase-23 process: the command, then whether it made a CUDA context.
SWEEP_NO_CUDA = (
    "import runpy, sys, torch\n"
    "kind, argv = sys.argv[1], sys.argv[2:]\n"
    "if kind == 'tool':\n"
    "    sys.argv = [argv[0], *argv[1:]]\n"
    "    try:\n"
    "        runpy.run_module('gpuschedule_tpu_torch.tools.' + argv[0], run_name='__main__',\n"
    "                         alter_sys=True)\n"
    "        rc = 0\n"
    "    except SystemExit as e:\n"
    "        rc = e.code if isinstance(e.code, int) else int(e.code is not None)\n"
    "else:\n"
    "    from gpuschedule_tpu_torch.cli import main\n"
    "    parts, part = [], []\n"
    "    for a in argv:\n"
    "        if a == '--then':\n"
    "            parts.append(part)\n"
    "            part = []\n"
    "        else:\n"
    "            part.append(a)\n"
    "    for part in parts + [part]:\n"
    "        rc = main(part)\n"
    "        sys.stdout.flush()\n"
    "        if rc:\n"
    "            break\n"
    "print(f'cuda_initialized={torch.cuda.is_initialized()}', file=sys.stderr)\n"
    "sys.exit(rc)")
ROOT = Path(__file__).resolve().parent


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_report(log_text: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads", "static_smem"}}
    from nvcc's ``-Xptxas -v`` output."""
    out: dict = {}
    name = None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[name]["static_smem"] = int(m.group(1))
    return out


# a tensor-core kernel's output type as it is mangled after its head dim
MANGLED_OUT = {"bf16": "13__nv_bfloat16E", "f32": "fE"}


def mangled_name(names, kernel: str, d: int, out: str = ""):
    """The mangled name among ``names`` of ``kernel`` at head dim ``d``
    whose template arguments go on with ``out`` (``MANGLED_OUT``: the
    tensor-core kernels' output type), or None."""
    for name in names:
        if f"{len(kernel)}{kernel}I" in name and f"Li{d}E{out}" in name:
            return name
    return None


def cuobjdump_path():
    """cuobjdump beside nvcc, on PATH, or the copy Triton bundles; else None."""
    from gpuschedule_tpu_torch.ops import _build

    cands = [Path(_build.nvcc_path()).parent / "cuobjdump", shutil.which("cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(Path(spec.origin).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    for c in cands:
        if c and Path(c).is_file():
            return str(c)
    return None


def hmma_counts(lib_path: str, tool: str) -> dict:
    """{mangled kernel name: number of HMMA instructions} in the library's SASS."""
    res = subprocess.run([tool, "--dump-sass", lib_path], capture_output=True, text=True,
                         timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr.strip()[:500]}")
    counts: dict = {}
    name = None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts.setdefault(name, 0)
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


def profile_steps(torch, trainer, state, tokens, steps: int = 2, kernels=(), feed=None,
                  agree=None) -> dict:
    """Device time by kernel over ``steps`` train steps in a profiler window
    (``device_window``: pads and a marker first, a lost window taken again
    up to the harness's WINDOWS windows; ranks that
    step together pass ``agree`` (:func:`ranks_agree`) and take a window
    again together, and a feed holds a window's steps for each window that
    may be taken again), each step on
    ``tokens`` or, given ``feed``, on the feed's next batch: per-step ms of
    the top kernels, their sum, the busy share of the profiled window's
    wall time (the profiler's own overhead lands in the idle share; the
    caller adds the share of an unprofiled step), the launches a step of
    each kernel named in ``kernels``, and ``steps_run``, the steps of every
    window taken (a caller's launch counters count them all).  A failing
    step, and a run of lost windows, fail the run."""
    from gpuschedule_tpu_torch.profiler.harness import LostWindow, device_window

    box = [state]

    def step():
        box[0], _ = trainer.step(box[0], tokens if feed is None else next(feed))

    try:
        win = device_window(step, steps, what="profile_steps", warm=False, agree=agree)
    except LostWindow as e:
        raise SmokeFailure(str(e)) from None
    by_name: dict = {}
    counts = {k: 0 for k in kernels}
    for rec in win.device:
        by_name[rec.name] = by_name.get(rec.name, 0.0) + rec.us / 1e3
        for k in kernels:
            counts[k] += k in rec.name
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "steps": steps, "steps_run": steps * (win.lost + 1),
        "wall_ms_per_step": win.wall_ms / steps,
        "device_ms_per_step": busy / steps, "busy_share": busy / win.wall_ms,
        "top": [{"kernel": n[:90], "ms_per_step": t / steps, "share": t / busy} for n, t in top],
        "launches_per_step": {k: c / steps for k, c in counts.items()},
    }


def ranks_agree(torch, dist):
    """``device_window``'s ``agree`` for ranks that step together: whether
    every rank kept its window, by an all-reduce (MIN) of the verdicts."""
    def agree(kept: bool) -> bool:
        flag = torch.tensor([int(kept)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())
    return agree


def tile_rel_err(torch, got, ref) -> float:
    """The largest relative L2 error over the 64-row tiles of each (b, h) of
    a (B, S, H, D) tensor: each tile's error over the norm of ``ref``'s
    tile, so a fault where the values are small (late rows of a long causal
    output, late keys' gradients) is weighed against their own size."""
    b, s, h, d = ref.shape
    pad = -s % TILE

    def tile_norms(x):
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return torch.linalg.vector_norm(x.view(b, -1, TILE, h, d), dim=(2, 4))

    err = tile_norms(got.float() - ref.float()) / tile_norms(ref).clamp_min(1e-30)
    return err.max().item()


def parity_errors(torch, fa, dev, shape, dtype, causal, seed, out_dtype=None) -> dict:
    """The three flash kernels against their plain versions on seeded
    inputs of ``shape``, outputs in ``out_dtype`` (None: the inputs'): for
    out, dq, dk and dv the max abs error (``abs``), that error over the
    plain tensor's largest entry (``rel``) and :func:`tile_rel_err`
    (``tile``); the lse rows' max abs error; the outputs' dtypes
    (``dtypes``).  With ``out_dtype`` f32 from bf16 inputs (the f32 forms)
    also whether each output, rounded to bf16, is the bf16 form's to the bit
    (``bitwise``): the two forms differ only in the epilogue's store."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(4))
    kw = {"out_dtype": out_dtype}
    out, lse = fa.flash_fwd(q, k, v, causal=causal, **kw)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, **kw)
    delta = fa.attention_delta(out_p, g)
    dq = fa.flash_bwd_dq(q, k, v, g, lse_p, delta, causal=causal, **kw)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, g, lse_p, delta, causal=causal, **kw)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, g, lse_p, delta, causal, **kw)
    dk_p, dv_p = fa.flash_bwd_dkdv_plain(q, k, v, g, lse_p, delta, causal, **kw)
    torch.cuda.synchronize()
    errs = {"lse": (lse - lse_p).abs().max().item(),
            "dtypes": {str(t.dtype) for t in (out, dq, dk, dv, out_p, dq_p, dk_p, dv_p)}}
    if out_dtype == torch.float32 and dtype == torch.bfloat16:
        narrow = (fa.flash_fwd(q, k, v, causal=causal)[0],
                  fa.flash_bwd_dq(q, k, v, g, lse_p, delta, causal=causal),
                  *fa.flash_bwd_dkdv(q, k, v, g, lse_p, delta, causal=causal))
        errs["bitwise"] = all(torch.equal(w.to(dtype), n)
                              for w, n in zip((out, dq, dk, dv), narrow))
    for name, a, b in (("out", out, out_p), ("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
        diff = (a.float() - b.float()).abs().max().item()
        errs[name] = {"abs": diff, "rel": diff / max(b.float().abs().max().item(), 1e-6),
                      "tile": tile_rel_err(torch, a, b)}
    return errs


def captured_update_check(torch, trainer, state, tokens, make_optimizer):
    """Phase 5: one replayed step's adamw update (the fused capturable form,
    its rate on the device) against the update that the multi-tensor adamw
    with a host rate makes from the same parameters, gradients and moments:
    their difference over that update's size (relative L2 over all
    parameters) must stay below UPDATE_RTOL.  Returns ``(state, that ratio)``."""
    adamw = state.optimizer.adamw
    params = [p for group in adamw.param_groups for p in group["params"]]
    before = [p.detach().clone() for p in params]
    moments = [{name: t.clone() for name, t in adamw.state[p].items()} for p in params]
    lr = float(adamw.param_groups[0]["lr"])
    state, _ = trainer.step(state, tokens)        # the gradients stay in p.grad
    copies = [torch.nn.Parameter(p0.clone()) for p0 in before]
    for c, p in zip(copies, params):
        c.grad = p.grad.detach().clone()
    ref = make_optimizer(copies, lr, capturable=False).adamw
    for c, m in zip(copies, moments):
        ref.state[c] = {"step": m["step"].cpu(), "exp_avg": m["exp_avg"],
                        "exp_avg_sq": m["exp_avg_sq"]}
    ref.step()
    norm = torch.linalg.vector_norm
    diff = norm(torch.stack([norm(p.detach() - c.detach()) for p, c in zip(params, copies)]))
    size = norm(torch.stack([norm(c.detach() - p0) for c, p0 in zip(copies, before)]))
    rel = (diff / size).item()
    log(f"one captured adamw update vs the multi-tensor adamw's from the same state: "
        f"relative L2 {rel:.3e} of the update (bound {UPDATE_RTOL}, lr {lr})")
    check(rel < UPDATE_RTOL, "the captured adamw update disagrees with the multi-tensor one")
    return state, rel


def kernel_parity(torch, fa, dev, shape, dtype, causal, seed, out_dtype=None) -> dict:
    """:func:`parity_errors`, held to the bounds: out's max abs error below
    FWD_TOL, lse's below LSE_TOL, each gradient's below GRAD_TOL of the
    plain gradient's largest entry, and every output's tile error below
    TILE_RTOL; with ``out_dtype`` every output in it, and the f32 forms
    bitwise the bf16 forms once rounded.  Returns each kernel's max abs
    error and largest tile error."""
    e = parity_errors(torch, fa, dev, shape, dtype, causal, seed, out_dtype)
    if out_dtype is not None:
        check(e["dtypes"] == {str(out_dtype)}, f"outputs at {shape} are {e['dtypes']}, "
                                               f"not {out_dtype}")
    if "bitwise" in e:
        check(e["bitwise"], f"an f32 form rounded to bf16 is not the bf16 form at {shape}")
    out, dq, dk, dv = e["out"], e["dq"], e["dk"], e["dv"]
    log(f"parity {shape} {dtype} causal={causal} out_dtype={out_dtype} bitwise "
        f"{e.get('bitwise')}: out {out['abs']:.3e} lse {e['lse']:.3e} "
        f"dq {dq['abs']:.3e} ({dq['rel']:.2e} rel) dk {dk['abs']:.3e} ({dk['rel']:.2e}) "
        f"dv {dv['abs']:.3e} ({dv['rel']:.2e}); by 64-row tile out {out['tile']:.2e} "
        f"dq {dq['tile']:.2e} dk {dk['tile']:.2e} dv {dv['tile']:.2e}")
    check(out["abs"] < FWD_TOL and e["lse"] < LSE_TOL, f"forward kernel disagrees at {shape}")
    check(max(dq["rel"], dk["rel"], dv["rel"]) < GRAD_TOL,
          f"backward kernels disagree at {shape}")
    tiles = {"flash_fwd": out["tile"], "flash_bwd_dq": dq["tile"],
             "flash_bwd_dkdv": max(dk["tile"], dv["tile"])}
    check(max(tiles.values()) < TILE_RTOL,
          f"a 64-row tile of a kernel's output disagrees at {shape}: {tiles}")
    return {"abs": {"flash_fwd": out["abs"], "flash_bwd_dq": dq["abs"],
                    "flash_bwd_dkdv": max(dk["abs"], dv["abs"])}, "tile": tiles}


def probe_parity(torch, dev, sizes) -> dict:
    """Phase 7: both probe kernels in both launch forms against their plain
    versions on seeded (n * 8, 128) bf16 inputs; returns the largest abs
    error of each."""
    from gpuschedule_tpu_torch.ops import overhead_probe as op

    errs = {name: 0.0 for name in PROBE_KERNELS}
    for i, n in enumerate(sizes):
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        x = torch.randn((n * 8, PROBE_BLOCK), generator=gen, device=dev).to(torch.bfloat16)
        ref_c, ref_m = op.probe_copy_plain(x), op.probe_matmul_plain(x)
        for parallel in (False, True):
            c, m = op.probe_copy(x, parallel=parallel), op.probe_matmul(x, parallel=parallel)
            torch.cuda.synchronize()
            e_c = (c.float() - ref_c.float()).abs().max().item()
            e_m = (m.float() - ref_m.float()).abs().max().item()
            ulps = op.bf16_ulps(m, ref_m)
            log(f"probe parity n={n} parallel={parallel}: copy {e_c:.3e} "
                f"(equal {torch.equal(c, ref_c)}) xtx {e_m:.3e} ({ulps:.2f} bf16 ulp)")
            check(torch.equal(c, ref_c), f"the copy kernel disagrees at n={n} parallel={parallel}")
            check(ulps <= 1.0, f"the xtx kernel is {ulps} bf16 ulp off at n={n} parallel={parallel}")
            errs["probe_copy"] = max(errs["probe_copy"], e_c)
            errs["probe_matmul"] = max(errs["probe_matmul"], e_m)
    return errs


def probe_sweeps(torch, dev, n, ms, peaks):
    """Phase 8: the overhead probe's four sweeps (its main path, counted),
    then each kernel at n tiles in both forms: CUDA-event ms, device ms per
    launch and the wrapper's host µs per call (``tools/probe_costs.py``),
    beside its plain version, the library call of the same function and the
    bound.  Returns (launches, times, bounds) by kernel."""
    from gpuschedule_tpu_torch.ops import overhead_probe as op
    from gpuschedule_tpu_torch.tools import overhead_probe as probe_tool
    from gpuschedule_tpu_torch.tools.probe_costs import probe_input, wrapper_costs
    from gpuschedule_tpu_torch.tools.roofline import bound, probe_cost

    op.reset_launches()                           # the probe's main path starts here
    for kernel, name, parallel in probe_tool.SWEEPS:
        probe_tool.sweep(kernel, name, parallel, device=dev)
    launches = dict(op.LAUNCHES)                  # ... and ends here
    log(f"probe sweep launches: {launches}")
    check(all(launches[name] > 0 for name in PROBE_KERNELS),
          f"the probe sweeps did not run every kernel: {launches}")
    costs = wrapper_costs(n)
    x = probe_input(n)
    xt, out = x.view(n, 8, PROBE_BLOCK), torch.empty_like(x)
    yardsticks = {"probe_copy": (op.probe_copy_plain, lambda: out.copy_(x)),
                  "probe_matmul": (op.probe_matmul_plain,
                                   lambda: torch.bmm(xt[:, :, :8].transpose(1, 2), xt))}
    times, bounds = {}, {}
    for name, (plain, library) in yardsticks.items():
        par, seq = costs[name, True], costs[name, False]
        times[name] = {
            "ms": par["ms"], "ms_sequential": seq["ms"],
            "device_ms": par["device_ms"], "device_ms_sequential": seq["device_ms"],
            "host_us": par["host_us"], "host_us_sequential": seq["host_us"],
            "plain_ms": ms(lambda: plain(x)), "library_ms": ms(library),
        }
        check(par["device_ms"] is not None and seq["device_ms"] is not None,
              f"the profiler recorded no device time for {name}")
        flops, nbytes = probe_cost(n, PROBE_BLOCK, name)
        bounds[name] = bound(flops, nbytes, peaks)
        t = times[name]
        log(f"time {name} n={n} block={PROBE_BLOCK} bf16: {t['ms']:.5f} ms parallel "
            f"(device {t['device_ms']:.5f} ms a launch, host {t['host_us']:.2f} us a call), "
            f"{t['ms_sequential']:.5f} ms sequential (device {t['device_ms_sequential']:.5f} "
            f"ms, host {t['host_us_sequential']:.2f} us); plain {t['plain_ms']:.5f} ms, "
            f"library {t['library_ms']:.5f} ms, bound {bounds[name][0]:.5f} ms by "
            f"{bounds[name][1]}, {flops / 1e6:.1f} MFLOP, {nbytes / 1e6:.2f} MB")
    return launches, times, bounds


def profile_phase(torch, smi, dense_s, model="transformer-large", batch=16, seq=512,
                  device=None) -> dict:
    """Phase 9: the profile path.  ``profile_model`` fits ``model``'s curve
    into a fresh ``CurveCache``, which must reload with every k, finite
    non-negative theta and a measured k = 1 step within PROFILE_RTOL of
    ``dense_s`` (the same model, batch and sequence length timed by phase
    6); then ``capture_trace`` of 2 steps must write its file."""
    from gpuschedule_tpu_torch.profiler import CurveCache, capture_trace, profile_model

    with tempfile.TemporaryDirectory() as tmp:
        cache_path = os.path.join(tmp, "curves.json")
        torch.cuda.synchronize()
        held0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        curve = profile_model(model, batch_size=batch, seq_len=seq, ks=PROFILE_KS,
                              cache=CurveCache(cache_path), device=device)
        profile_s = time.perf_counter() - t0
        # each measured trainer, its captured graph and the graph's pool
        # with it, is gone once profile_model returns
        kept_mib = (torch.cuda.memory_allocated() - held0) / 2**20
        log(f"profile: {kept_mib:.1f} MiB still allocated after profile_model "
            f"(bound {PROFILE_KEPT_MIB} MiB)")
        check(kept_mib <= PROFILE_KEPT_MIB, "profile_model keeps a trainer's memory")
        reloaded = CurveCache(cache_path).get(model)
        with open(cache_path) as f:
            entry = json.load(f)[model]
        check(reloaded is not None and reloaded.theta == curve.theta,
              "the curve cache does not reload the fitted curve")
        check(all(math.isfinite(t) and t >= 0 for t in curve.theta),
              f"theta is not finite and non-negative: {curve.theta}")
        check(sorted(int(k) for k in entry["points"]) == list(PROFILE_KS),
              f"the cache lacks ks: {sorted(entry['points'])}")
        measured_s = entry["points"]["1"]
        rel = abs(measured_s - dense_s) / dense_s
        check(rel <= PROFILE_RTOL, f"profiled k=1 step {measured_s * 1e3:.3f} ms is {rel:.1%} "
                                   f"off phase 6's {dense_s * 1e3:.3f} ms")
        t0 = time.perf_counter()
        trace = capture_trace(model, os.path.join(tmp, "trace"), batch_size=batch,
                              seq_len=seq, steps=2, device=device)
        trace_s = time.perf_counter() - t0
        check(os.path.isfile(trace) and os.path.getsize(trace) > 0, f"no trace at {trace}")
        with open(trace) as f:
            events = json.load(f).get("traceEvents", [])
        return {
            "model": model, "batch": batch, "seq": seq, "card": smi, "entry_keys": sorted(entry),
            "theta": list(curve.theta), "source": entry["source"], "points": entry["points"],
            "multislice": entry.get("multislice"), "measured_ms": measured_s * 1e3,
            "dense_step_ms": dense_s * 1e3, "rel_to_dense": rel, "profile_s": profile_s,
            "trace_s": trace_s, "trace_bytes": os.path.getsize(trace), "kept_mib": kept_mib,
            "trace_kernel_events": sum(e.get("cat") == "kernel" for e in events),
        }


def bench_phase(torch) -> dict:
    """Phase 10: the port's bench (``python -m gpuschedule_tpu_torch.bench``)
    in a subprocess, with this process's cached memory handed back first.
    Its one line must show every cell run, right and on the kernels (see
    the module docstring); returns the line."""
    torch.cuda.empty_cache()
    held_gib = torch.cuda.memory_reserved() / 2**30
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "gpuschedule_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=BENCH_TIMEOUT_S, cwd=ROOT)
    bench_s = time.perf_counter() - t0
    for text in res.stderr.splitlines():
        print(f"bench: {text}", file=sys.stderr)
    lines = res.stdout.strip().splitlines()
    log(f"bench: exit {res.returncode} after {bench_s:.1f} s, this process holding "
        f"{held_gib:.2f} GiB; {lines[-1] if lines else 'no output'}")
    check(res.returncode == 0 and bool(lines), f"the bench exited {res.returncode}")
    line = json.loads(lines[-1])
    check(line.get("value", 0) > 0 and "mfu" in line, "the bench's dense cell has no rate or mfu")
    for key in ("flash", "longctx"):
        sub = line.get(key)
        check(isinstance(sub, dict) and "failed" not in sub and "skipped" not in sub,
              f"the bench's {key} cell did not run: {sub}")
    fl, lc = line["flash"], line["longctx"]
    check(fl["fwd_maxerr"] < FWD_TOL and fl["bwd_relerr"] < GRAD_TOL and fl["compiled"],
          f"the bench's flash cell: {fl}")
    check(lc["seq_len"] == LONGCTX_SHAPE[1] and lc["dense_feasible"] in (True, False)
          and lc["loss"] is not None and math.isfinite(lc["loss"]),
          f"the bench's long-context cell: {lc}")
    for cell, need in ((fl, {"flash_fwd": 8, "flash_bwd_dq": 4, "flash_bwd_dkdv": 4}),
                       (lc, LONGCTX_PER_STEP)):
        per_step = {name: cell["launches"][name] / cell["steps"] for name in KERNELS}
        check(all(per_step[name] >= need[name] for name in KERNELS),
              f"a bench train step did not run every kernel: {per_step} per step")
    return {**line, "bench_s": bench_s, "held_gib": held_gib}


def longctx_profile(torch, fa, step_ms) -> dict:
    """Phase 10: the bench's long-context step (transformer-xlong, b1 x
    S32768, flash + remat) once more in this process, for a profiler window
    of 2 replayed steps: its kernels and its device busy share of the
    bench's unprofiled ``step_ms``.  The launches of each kernel the
    profiler sees in a replayed step must be LONGCTX_PER_STEP, and the
    counters' (added on each replay from what the capture recorded) the
    same."""
    from gpuschedule_tpu_torch.parallel import ShardedTrainer

    b, s, _, _ = LONGCTX_SHAPE
    trainer = ShardedTrainer("transformer-xlong", batch_size=b, seq_len=s, flash_attn=True)
    state = trainer.init(seed=0)
    tokens = trainer.make_batch(seed=0)
    for _ in range(3):  # a warm-up, the capture and its replay, a replay
        state, _ = trainer.step(state, tokens)
    before = dict(fa.LAUNCHES)
    prof = profile_steps(torch, trainer, state, tokens,
                         kernels=[KERNELS[name][0] for name in KERNELS])
    check("device_ms_per_step" in prof, f"long-context step profile: {prof}")
    prof["busy_share_of_step"] = prof["device_ms_per_step"] / step_ms
    log(f"long-context step profile: {json.dumps(prof)}")
    window = {name: (fa.LAUNCHES[name] - before[name]) / prof["steps_run"] for name in KERNELS}
    seen = {name: prof["launches_per_step"][KERNELS[name][0]] for name in KERNELS}
    log(f"launches a replayed long-context step: counters {window}, profiler {seen}, "
        f"expected {LONGCTX_PER_STEP}")
    check(seen == window == LONGCTX_PER_STEP,
          f"long-context step: the profiler's kernels {seen}, the counters' {window}, "
          f"expected {LONGCTX_PER_STEP}")
    del state, trainer, tokens
    torch.cuda.empty_cache()
    return prof


def longctx_kernels(torch, fa, dev, ms, peaks, F) -> dict:
    """Phase 10: K1, K2 and K3 at the long-context shape against their plain
    versions (phase 3's bounds), then their event times beside the plain
    versions', the bound, SDPA's forward (K1's yardstick) and SDPA's flash
    backward (K2's and K3's together) at the same shape.  At this S
    the outputs of late rows and the gradients of late keys are far smaller
    than the largest entries, so only the tile bound (TILE_RTOL) sees a
    fault confined to late tiles: ``scripts/longctx_fault_check.py`` plants
    such faults and shows that they fail it."""
    from gpuschedule_tpu_torch.profiler import time_callable
    from gpuschedule_tpu_torch.tools.roofline import attention_cost, bound

    b, s, h, d = LONGCTX_SHAPE
    errs = kernel_parity(torch, fa, dev, LONGCTX_SHAPE, torch.bfloat16, True, 400)
    gen = torch.Generator(device=dev).manual_seed(401)
    q, k, v, g = (torch.randn(LONGCTX_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = fa.attention_delta(out, g)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal=True),
                      lambda: fa.flash_fwd_plain(q, k, v, True)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=True),
                         lambda: fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, True)),
        "flash_bwd_dkdv": (lambda: fa.flash_bwd_dkdv(q, k, v, g, lse, delta, causal=True),
                           lambda: fa.flash_bwd_dkdv_plain(q, k, v, g, lse, delta, True)),
    }
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_ms = ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 10)
    sdpa_bwd = sdpa_backward_ms(torch, q, k, v, g, ms)
    kernels = {}
    for name, (kernel, plain) in calls.items():
        flops, nbytes = attention_cost(b, s, h, d, True, 2, name)
        bound_ms, bound_by = bound(flops, nbytes, peaks)
        k_ms = ms(kernel, 10)
        p_ms = time_callable(plain, iters=1, warmup=1, device=dev) * 1e3
        kernels[name] = {"shape": list(LONGCTX_SHAPE), "tile_rel_err": errs["tile"][name],
                         "ms": k_ms, "plain_ms": p_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": sdpa_ms if name == "flash_fwd" else sdpa_bwd}
        log(f"time {name} {LONGCTX_SHAPE} bf16 causal: {k_ms:.4f} ms (plain {p_ms:.2f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by}, {flops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB; {k_ms / bound_ms:.2f}x the bound)")
    log(f"time sdpa forward {LONGCTX_SHAPE} bf16 causal: {sdpa_ms:.4f} ms; K2 + K3 "
        f"{kernels['flash_bwd_dq']['ms'] + kernels['flash_bwd_dkdv']['ms']:.4f} ms vs sdpa "
        f"flash backward (dq, dk, dv in one call) {sdpa_bwd:.4f} ms")
    return {"max_abs_err": errs["abs"], "kernels": kernels}


def f32_forms(torch, fa, dev, ms, peaks, F) -> dict:
    """Phase 11 (i): the f32-output forms of K1-K3 (bf16 inputs, the ring's
    chunk ops) against their plain versions (:func:`kernel_parity` with
    ``out_dtype`` f32: phase 3's bounds, the dtype, the bf16 form to the
    bit once rounded) at the ring's chunk shape, causal (a diagonal pair)
    and full (a past pair), and at two ragged shapes; then their event
    times at the chunk shape beside their plain versions, bounds (f32
    outputs: 4 bytes an element written), SDPA's forward and SDPA's flash
    backward (bf16 outputs: the nearest library call)."""
    from gpuschedule_tpu_torch.profiler import time_callable
    from gpuschedule_tpu_torch.tools.roofline import attention_cost, bound

    f32, bf16 = torch.float32, torch.bfloat16
    errs = {name: 0.0 for name in F32_FORMS}
    tiles = {name: 0.0 for name in F32_FORMS}
    cases = [(RING_CHUNK_SHAPE, True), (RING_CHUNK_SHAPE, False),
             ((2, 1000, 4, 32), True), ((1, 333, 2, 96), False)]
    for i, (shape, causal) in enumerate(cases):
        e = kernel_parity(torch, fa, dev, shape, bf16, causal, 500 + i, out_dtype=f32)
        for name in KERNELS:
            errs[f"{name}_f32"] = max(errs[f"{name}_f32"], e["abs"][name])
            tiles[f"{name}_f32"] = max(tiles[f"{name}_f32"], e["tile"][name])
    b, s, h, d = RING_CHUNK_SHAPE
    gen = torch.Generator(device=dev).manual_seed(510)
    q, k, v, g = (torch.randn(RING_CHUNK_SHAPE, generator=gen, device=dev).to(bf16)
                  for _ in range(4))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    times = {name: {} for name in F32_FORMS}
    for causal in (False, True):
        out, lse = fa.flash_fwd(q, k, v, causal=causal, out_dtype=f32)
        delta = fa.attention_delta(out.to(bf16), g)
        calls = {
            "flash_fwd_f32": (lambda: fa.flash_fwd(q, k, v, causal=causal, out_dtype=f32),
                              lambda: fa.flash_fwd_plain(q, k, v, causal, out_dtype=f32)),
            "flash_bwd_dq_f32": (
                lambda: fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=causal, out_dtype=f32),
                lambda: fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, causal, out_dtype=f32)),
            "flash_bwd_dkdv_f32": (
                lambda: fa.flash_bwd_dkdv(q, k, v, g, lse, delta, causal=causal, out_dtype=f32),
                lambda: fa.flash_bwd_dkdv_plain(q, k, v, g, lse, delta, causal,
                                                out_dtype=f32)),
        }
        sdpa_ms = ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), 10)
        sdpa_bwd = sdpa_backward_ms(torch, q, k, v, g, ms, causal)
        pair = "diagonal" if causal else "past"
        for name, (kernel, plain) in calls.items():
            flops, nbytes = attention_cost(b, s, h, d, causal, 2, name, out_esize=4)
            bound_ms, bound_by = bound(flops, nbytes, peaks)
            k_ms = ms(kernel, 10)
            p_ms = time_callable(plain, iters=1, warmup=1, device=dev) * 1e3
            times[name][pair] = {"shape": list(RING_CHUNK_SHAPE), "causal": causal, "ms": k_ms,
                                 "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                                 "library_ms": sdpa_ms if name == "flash_fwd_f32" else sdpa_bwd}
            log(f"time {name} {RING_CHUNK_SHAPE} bf16 in, f32 out, {pair} pair: {k_ms:.4f} ms "
                f"(plain {p_ms:.2f} ms, bound {bound_ms:.4f} ms by {bound_by}, "
                f"{k_ms / bound_ms:.2f}x the bound)")
        log(f"time sdpa forward {RING_CHUNK_SHAPE} bf16 causal={causal}: {sdpa_ms:.4f} ms; "
            f"sdpa flash backward (dq, dk, dv in one call, bf16 out): {sdpa_bwd:.4f} ms")
    return {"max_abs_err": errs, "tile_rel_err": tiles, "times": times}


def _fwd_bwd(torch, fn, q, k, v, g):
    """(out, (dq, dk, dv)) of the attention op ``fn`` with cotangent g."""
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    return out.detach(), torch.autograd.grad(out, (q, k, v), g)


def ring_vs_flash(torch, fa, dev, ms) -> dict:
    """Phase 11 (ii): ``ring_flash_attention_in_process`` at sp = RING_SP
    on the long-context shape against the flash op on the whole sequence
    (K1-K3), forward and backward: out within FWD_TOL, each gradient within
    GRAD_TOL of the flash gradient's largest entry, every 64-row tile
    within TILE_RTOL; RING_PAIRS launches of each f32 form a pass and none
    of the bf16 forms.  Then both timed (CUDA events), forward alone and
    forward with backward."""
    from gpuschedule_tpu_torch.parallel.ringflash import ring_flash_attention_in_process

    gen = torch.Generator(device=dev).manual_seed(600)
    q, k, v, g = (torch.randn(LONGCTX_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(4))
    ring = lambda q, k, v: ring_flash_attention_in_process(  # noqa: E731
        q, k, v, sp=RING_SP, causal=True)
    flash = lambda q, k, v: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
    fa.reset_launches()
    out_r, grads_r = _fwd_bwd(torch, ring, q, k, v, g)
    torch.cuda.synchronize()
    per_pass = dict(fa.LAUNCHES)
    log(f"launches of one ring pass (forward and backward), sp={RING_SP}: {per_pass}")
    check(per_pass == {**dict.fromkeys(KERNELS, 0), **dict.fromkeys(F32_FORMS, RING_PAIRS)},
          f"a ring pass launched {per_pass}, not {RING_PAIRS} of each f32 form and nothing else")
    out_f, grads_f = _fwd_bwd(torch, flash, q, k, v, g)
    torch.cuda.synchronize()
    errs = {"out": (out_r.float() - out_f.float()).abs().max().item()}
    tiles = {"out": tile_rel_err(torch, out_r, out_f)}
    for name, a, b in zip(("dq", "dk", "dv"), grads_r, grads_f):
        errs[name] = (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
        tiles[name] = tile_rel_err(torch, a, b)
    log(f"ring-flash sp={RING_SP} vs the flash op {LONGCTX_SHAPE} bf16 causal: out "
        f"{errs['out']:.3e} abs, dq {errs['dq']:.2e} dk {errs['dk']:.2e} dv {errs['dv']:.2e} of "
        f"the largest entry; by 64-row tile {tiles}")
    check(errs["out"] < FWD_TOL and max(errs["dq"], errs["dk"], errs["dv"]) < GRAD_TOL,
          "the ring-flash disagrees with the flash op")
    check(max(tiles.values()) < TILE_RTOL,
          f"a 64-row tile of the ring-flash disagrees with the flash op: {tiles}")
    with torch.no_grad():
        times = {"ring_fwd_ms": ms(lambda: ring(q, k, v), 5),
                 "flash_fwd_ms": ms(lambda: flash(q, k, v), 5)}
    times["ring_fwd_bwd_ms"] = ms(lambda: _fwd_bwd(torch, ring, q, k, v, g), 5)
    times["flash_fwd_bwd_ms"] = ms(lambda: _fwd_bwd(torch, flash, q, k, v, g), 5)
    log(f"time ring-flash sp={RING_SP} in process {LONGCTX_SHAPE} bf16 causal: forward "
        f"{times['ring_fwd_ms']:.4f} ms (the flash op {times['flash_fwd_ms']:.4f}), forward "
        f"and backward {times['ring_fwd_bwd_ms']:.4f} ms ({times['flash_fwd_bwd_ms']:.4f})")
    return {"shape": list(LONGCTX_SHAPE), "sp": RING_SP, "launches_per_pass": per_pass,
            "errors": errs, "tile_rel_err": tiles, **times}


def ring_model(torch, fa, dev) -> dict:
    """Phase 11 (iii), the slice at full width: transformer-xlong (remat) at
    b1 x S32768 with the in-process ring-flash at sp = RING_SP as its
    attention core, forward and backward on one batch (after one warm-up
    of each model, timed by the host clock), against the flash
    model of the same parameters: the loss within LOSS_RTOL, every
    parameter's gradient within RING_GRAD_RTOL (relative L2; a key bias,
    whose exact gradient is 0, against its key kernel's).  Its launches
    of the f32 forms (the counts set to 0 just before, read just after)
    are RING_MODEL_LAUNCHES."""
    from functools import partial

    from gpuschedule_tpu_torch.data import synthetic_lm_batches
    from gpuschedule_tpu_torch.models import build_model
    from gpuschedule_tpu_torch.parallel import ShardedTrainer
    from gpuschedule_tpu_torch.parallel.ringflash import ring_flash_attention_in_process

    b, s = LONGCTX_SHAPE[:2]
    with dev:
        ring_lm, cfg = build_model("transformer-xlong", attn_fn=partial(
            ring_flash_attention_in_process, sp=RING_SP, causal=True))
        flash_lm, _ = build_model("transformer-xlong",
                                  attn_fn=partial(fa.flash_attention, causal=True))
    ring_lm.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    flash_lm.load_state_dict(ring_lm.state_dict())
    tokens = torch.from_numpy(next(synthetic_lm_batches(
        batch_size=b, seq_len=s, vocab=cfg.vocab, num_batches=1, seed=0))).long().to(dev)

    def fwd_bwd(model):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = ShardedTrainer.loss(model(tokens), tokens)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), time.perf_counter() - t0

    for model in (ring_lm, flash_lm):  # warm-ups: allocator and libraries at this size
        fwd_bwd(model)
    fa.reset_launches()                           # the slice's main path starts here
    loss_r, ring_s = fwd_bwd(ring_lm)
    launches = dict(fa.LAUNCHES)                  # ... and ends here
    loss_f, flash_s = fwd_bwd(flash_lm)
    norm = torch.linalg.vector_norm
    flash_grads = {name: p.grad.float() for name, p in flash_lm.named_parameters()}
    # a key bias's exact gradient is 0 (a shift shared by every key of a row
    # leaves the softmax as it is), so both models hold rounding noise
    # there: its error is weighed against its layer's key kernel gradient
    scale = {name: norm(flash_grads[name.removesuffix("bias") + "kernel"]
                        if name.endswith("attn.key.bias") else g) for name, g in flash_grads.items()}
    grad_rel = {name: (norm(p.grad.float() - flash_grads[name]) / scale[name]).item()
                for name, p in ring_lm.named_parameters()}
    worst = max(grad_rel, key=grad_rel.get)
    rel_loss = abs(loss_r - loss_f) / abs(loss_f)
    log(f"transformer-xlong b{b} S{s}, ring-flash sp={RING_SP} vs flash: loss {loss_r:.6f} vs "
        f"{loss_f:.6f} (rel {rel_loss:.2e}, bound {LOSS_RTOL}); largest gradient error "
        f"{grad_rel[worst]:.3e} relative L2 ({worst}; bound {RING_GRAD_RTOL}), median "
        f"{sorted(grad_rel.values())[len(grad_rel) // 2]:.3e}; forward and backward "
        f"{ring_s * 1e3:.1f} ms vs {flash_s * 1e3:.1f} ms; launches {launches}")
    check(math.isfinite(loss_r) and rel_loss < LOSS_RTOL,
          "the ring-flash model's loss disagrees with the flash model's")
    check(grad_rel[worst] < RING_GRAD_RTOL,
          f"the ring-flash model's gradient of {worst} disagrees: {grad_rel[worst]:.3e}")
    check(launches == {**dict.fromkeys(KERNELS, 0), **RING_MODEL_LAUNCHES},
          f"the ring-flash model launched {launches}, not {RING_MODEL_LAUNCHES}")
    out = {"model": "transformer-xlong", "batch": b, "seq": s, "sp": RING_SP, "loss": loss_r,
           "flash_loss": loss_f, "loss_rel": rel_loss, "grad_rel_max": grad_rel[worst],
           "grad_rel_max_param": worst, "grad_rel": grad_rel, "launches": launches,
           "fwd_bwd_ms": ring_s * 1e3, "flash_fwd_bwd_ms": flash_s * 1e3}
    del ring_lm, flash_lm, tokens
    torch.cuda.empty_cache()
    return out


def dense_ring(torch, dev) -> dict:
    """Phase 11 (iv): the dense ring in process at sp = RING_SP on
    transformer-long's attention shape against the dense oracle, bf16,
    forward and backward: out within FWD_TOL, gradients within GRAD_TOL of
    the oracle's largest entry."""
    from gpuschedule_tpu_torch.ops import dense_attention
    from gpuschedule_tpu_torch.parallel.ringattn import ring_attention_in_process

    gen = torch.Generator(device=dev).manual_seed(700)
    q, k, v, g = (torch.randn(MAIN_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(4))
    out_r, grads_r = _fwd_bwd(torch, lambda q, k, v: ring_attention_in_process(
        q, k, v, sp=RING_SP, causal=True), q, k, v, g)
    out_d, grads_d = _fwd_bwd(torch, lambda q, k, v: dense_attention(q, k, v, causal=True),
                              q, k, v, g)
    errs = {"out": (out_r.float() - out_d.float()).abs().max().item()}
    for name, a, b in zip(("dq", "dk", "dv"), grads_r, grads_d):
        errs[name] = (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
    log(f"dense ring sp={RING_SP} vs the dense oracle {MAIN_SHAPE} bf16 causal: {errs}")
    check(errs["out"] < FWD_TOL and max(errs["dq"], errs["dk"], errs["dv"]) < GRAD_TOL,
          "the dense ring disagrees with the dense oracle")
    return {"shape": list(MAIN_SHAPE), "sp": RING_SP, "errors": errs}


def ring_cli() -> dict:
    """Phase 11 (v): ``train --ring-attn --flash-attn --sp 1`` under
    ``torchrun`` (one rank: a one-rank NCCL mesh), transformer-long b2 x
    S4096, 3 steps; its summary line must show the mesh and a finite,
    falling loss.  It checks that the launcher, a one-rank NCCL group and
    ``init_device_mesh`` start and that the CLI trains on them: at sp = 1
    the ring is the flash op, so no ring code runs here (the one rank runs
    the step captured over its NCCL group, which phase 17 checks)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", "-m", "gpuschedule_tpu_torch", "train", "--model", "transformer-long",
           "--steps", "3", "--batch-size", "2", "--seq-len", "4096", "--sp", "1",
           "--ring-attn", "--flash-attn"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=CLI_TIMEOUT_S, cwd=ROOT)
    for text in res.stderr.splitlines():
        print(f"train: {text}", file=sys.stderr)
    lines = res.stdout.strip().splitlines()
    log(f"train under torchrun: exit {res.returncode} after {time.perf_counter() - t0:.1f} s; "
        f"{lines[-1] if lines else 'no output'}")
    check(res.returncode == 0 and bool(lines), f"train under torchrun exited {res.returncode}")
    line = json.loads(lines[-1])
    check(line["mesh"] == {"pp": 1, "dp": 1, "sp": 1, "tp": 1}, f"mesh {line['mesh']}")
    check(math.isfinite(line["first_loss"]) and math.isfinite(line["last_loss"])
          and line["last_loss"] < line["first_loss"],
          f"train under torchrun: loss {line['first_loss']} -> {line['last_loss']}")
    return line


def moe_einsum_ms(torch, state, batch, ms) -> dict:
    """Phase 12: the MoE's dispatch and combine einsums alone, as the step
    runs them in block 0 (its input from a forward hook on the step's
    batch, its routing): forward (``td,tec->ecd`` and ``ecd,tec->td``) and
    backward (x's gradient through dispatch; out's and combine's through
    combine, which carries the gates' gradient), by CUDA events; and the
    routing that builds dispatch and combine, forward only."""
    moe = state.model.blocks[0].moe
    grab = {}
    hook = moe.register_forward_pre_hook(lambda mod, args: grab.setdefault("x", args[0]))
    with torch.no_grad():
        state.model(batch)
    hook.remove()
    x = grab["x"].detach()
    with torch.no_grad():
        dispatch, combine, _ = moe.route(x)
    t, d = x.shape[0] * x.shape[1], x.shape[2]
    e, cap = dispatch.shape[1], dispatch.shape[2]
    gen = torch.Generator(device=x.device).manual_seed(0)
    xf = x.reshape(t, d).requires_grad_(True)
    out, g_in = (torch.randn((e, cap, d), generator=gen, device=x.device).to(torch.bfloat16)
                 for _ in range(2))
    out.requires_grad_(True)
    g_y = torch.randn((t, d), generator=gen, device=x.device).to(torch.bfloat16)
    comb = combine.detach().requires_grad_(True)

    def fwd_bwd():
        expert_in = torch.einsum("td,tec->ecd", xf, dispatch)
        y = torch.einsum("ecd,tec->td", out, comb)
        return torch.autograd.grad((expert_in, y), (xf, out, comb), (g_in, g_y))

    with torch.no_grad():
        route_ms = ms(lambda: moe.route(x), 10)
    return {"tokens": t, "experts": e, "capacity": cap, "d_model": d,
            "einsums_fwd_bwd_ms": ms(fwd_bwd, 10), "route_fwd_ms": route_ms,
            "buffer_mib": dispatch.numel() * 2 / 2**20}


def zoo_cell(torch, fa, ms, model, batch, seq, peaks, flash=False) -> dict:
    """Phase 12, one cell: ``model``'s captured step at ``batch`` (and
    ``seq`` for an LM), as phase 5 runs the flash step: 5 steps (a
    warm-up, the capture and its replay, 2 replays) and ``time_steps``
    (10 x 3) with the launch counters set to 0 just before; the same 5
    steps through the eager path from the same init (losses within
    LOSS_RTOL); 3 replays with no host sync; a profiler window of 2
    replayed steps (the top device operations, the busy share of an
    unprofiled step, and with ``flash`` each flash kernel's launches,
    which must equal the counters' and MOE_FLASH_PER_STEP).  The loss must
    be finite and fall."""
    from gpuschedule_tpu_torch.parallel import ShardedTrainer
    from gpuschedule_tpu_torch.profiler import time_steps

    trainer = ShardedTrainer(model, batch_size=batch, flash_attn=flash,
                             **({} if seq is None else {"seq_len": seq}))
    state = trainer.init(seed=0)
    eager_state = trainer.init(seed=0)
    data = trainer.make_batch(seed=0)
    torch.cuda.synchronize()
    fa.reset_launches()                           # this cell's path starts here
    losses = []
    for _ in range(5):
        state, loss = trainer.step(state, data)
        losses.append(loss.item())
    step_s, state = time_steps(trainer.step, state, data, iters=10, repeats=3)
    launches = dict(fa.LAUNCHES)                  # ... and ends here
    n_steps = 5 + 10 * 3
    eager = []
    for _ in range(5):
        eager_state, loss = trainer._eager_step(eager_state, data)
        eager.append(loss.item())
    del eager_state
    capture_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, eager))
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, loss = trainer.step(state, data)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    before = dict(fa.LAUNCHES)
    names = [KERNELS[name][0] for name in KERNELS] if flash else []
    prof = profile_steps(torch, trainer, state, data, kernels=names)
    check("device_ms_per_step" in prof, f"{model} step profile: {prof}")
    prof["busy_share_of_step"] = prof["device_ms_per_step"] / (step_s * 1e3)
    units = batch if trainer.is_image else batch * seq
    flops = trainer.cfg.flops_per_token() * units / step_s
    cell = {
        "model": model, "batch": batch, "seq": None if trainer.is_image else seq,
        "flash": flash, "step_ms": step_s * 1e3,
        ("samples_per_s" if trainer.is_image else "tokens_per_s"): units / step_s,
        "mfu": flops / peaks["bf16_flops"], "losses": losses, "eager_losses": eager,
        "captured_vs_eager_loss_rel": capture_rel, "steps": n_steps, "launches": launches,
        "profile": prof,
    }
    log(f"zoo {model}{' flash' if flash else ''} b{batch}"
        f"{'' if trainer.is_image else f' S{seq}'}: {step_s * 1e3:.3f} ms/step, "
        f"{units / step_s:.1f} {'samples' if trainer.is_image else 'tokens'}/s, MFU "
        f"{cell['mfu']:.4f} (6N or per-sample FLOPs), device busy "
        f"{prof['busy_share_of_step']:.3f} of an unprofiled step; losses {losses} vs eager "
        f"{eager} (max rel {capture_rel:.2e}); top: "
        + "; ".join(f"{o['kernel'][:60]} {o['ms_per_step']:.3f} ms" for o in prof["top"][:5]))
    check(all(math.isfinite(x) for x in losses), f"{model}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{model}: the loss did not fall: {losses}")
    check(capture_rel < LOSS_RTOL, f"{model}: the captured step disagrees with the eager step")
    if flash:
        window = {name: (fa.LAUNCHES[name] - before[name]) / prof["steps_run"] for name in KERNELS}
        seen = {name: prof["launches_per_step"][KERNELS[name][0]] for name in KERNELS}
        log(f"launches a replayed {model} flash step: counters {window}, profiler {seen}")
        check(seen == window == MOE_FLASH_PER_STEP,
              f"{model} flash: the profiler's kernels {seen}, the counters' {window}, "
              f"expected {MOE_FLASH_PER_STEP}")
        check(all(launches[name] > 0 for name in KERNELS),
              f"{model} flash: a kernel never launched on its path: {launches}")
    elif not trainer.is_image and trainer.cfg.n_experts:
        cell["dispatch_combine"] = moe_einsum_ms(torch, state, data, ms)
        cell["dispatch_combine"]["share_of_step"] = (
            cell["dispatch_combine"]["einsums_fwd_bwd_ms"] * trainer.cfg.n_layers
            / (step_s * 1e3))
        log(f"{model} dispatch/combine einsums, forward and backward, alone: "
            f"{json.dumps(cell['dispatch_combine'])}")
    del state, trainer, data
    torch.cuda.empty_cache()
    return cell


def zoo_profile(torch, reference) -> dict:
    """Phase 12: ``profile_model`` for each of ZOO_PROFILE at the bench's
    batch into a fresh ``CurveCache``: its entry must have the keys, the
    ``source`` and the points (ks and their form) of phase 9's
    (``reference``), and finite non-negative theta."""
    from gpuschedule_tpu_torch.profiler import CurveCache, profile_model

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "curves.json")
        for model in ZOO_PROFILE:
            t0 = time.perf_counter()
            seq = {m: s for m, _, s in ZOO_CELLS}[model]
            curve = profile_model(model, batch_size=16, ks=PROFILE_KS, cache=CurveCache(path),
                                  **({} if seq is None else {"seq_len": seq}))
            with open(path) as f:
                entry = json.load(f)[model]
            check(sorted(entry) == reference["entry_keys"]
                  and entry["source"] == reference["source"]
                  and sorted(entry["points"]) == sorted(reference["points"])
                  and all(isinstance(v, float) for v in entry["points"].values()),
                  f"{model}: the curve entry is not in phase 9's form: {entry}")
            check(all(math.isfinite(t) and t >= 0 for t in curve.theta),
                  f"{model}: theta is not finite and non-negative: {curve.theta}")
            out[model] = {"theta": list(curve.theta), "k1_ms": entry["points"]["1"] * 1e3,
                          "profile_s": time.perf_counter() - t0}
    log(f"zoo profile: {json.dumps(out)}")
    return out


def zoo_phase(torch, fa, ms, smi, peaks, reference) -> dict:
    """Phase 12: the MoE (top-1 and top-2) and ResNet families at full
    width on the bench's batch (ZOO_CELLS), the MoE under the flash op
    (K1-K3's counters equal the profiler's; its first loss within
    LOSS_RTOL of the dense-attention MoE's from the same parameters; K1-K3
    against their plain versions at the attention shape that step gives
    them, within phase 3's bounds), their curves (``zoo_profile``) and the
    bench's dense cell on resnet-mid, which must report samples/s."""
    from gpuschedule_tpu_torch import bench
    from gpuschedule_tpu_torch.models import MODEL_CONFIGS

    t0 = time.perf_counter()
    cells = {m: zoo_cell(torch, fa, ms, m, b, s, peaks) for m, b, s in ZOO_CELLS}
    moe, batch, seq = ZOO_CELLS[0]
    flash = zoo_cell(torch, fa, ms, moe, batch, seq, peaks, flash=True)
    first_rel = abs(flash["losses"][0] - cells[moe]["losses"][0]) / abs(cells[moe]["losses"][0])
    log(f"{moe} first loss, flash {flash['losses'][0]:.6f} vs dense attention "
        f"{cells[moe]['losses'][0]:.6f} (rel {first_rel:.2e}, bound {LOSS_RTOL})")
    check(first_rel < LOSS_RTOL, f"{moe}: the flash and dense-attention losses disagree")
    flash["first_loss_rel_to_dense"] = first_rel
    cfg = MODEL_CONFIGS[moe]
    shape = (batch, seq, cfg.n_heads, cfg.d_model // cfg.n_heads)
    flash["parity_shape"] = shape
    flash["parity"] = kernel_parity(torch, fa, torch.device("cuda"), shape, torch.bfloat16,
                                    True, 600)
    curves = zoo_profile(torch, reference)
    line = bench.child_main("resnet-mid")
    check(line["unit"] == "samples/s" and line["value"] > 0 and "mfu" in line,
          f"the bench's resnet-mid line: {line}")
    torch.cuda.empty_cache()
    return {"card": smi, "cells": cells, "moe_flash": flash, "profile": curves,
            "bench_resnet_mid": line, "phase_s": time.perf_counter() - t0}


def _rel_l2(torch, a, b) -> float:
    """Relative L2 distance of two states' parameters, over all of them."""
    num = den = 0.0
    for (_, x), (_, y) in zip(a.model.named_parameters(), b.model.named_parameters()):
        num += (x.detach().double() - y.detach().double()).pow(2).sum().item()
        den += y.detach().double().pow(2).sum().item()
    return math.sqrt(num / den)


def _fed(ds, trainer, start, n, epoch=0):
    """``n`` batches of ``ds`` from ``start`` (then on through later
    epochs), cut, pinned and copied by ``prefetch_to_device``."""
    from gpuschedule_tpu_torch.data import prefetch_to_device

    def stream():
        e, first = epoch, start
        while True:
            yield from ds.batches(epoch=e, start=first)
            e, first = e + 1, 0
    return prefetch_to_device(itertools.islice(stream(), n), size=2,
                              sharding=trainer.batch_sharding)


def resume_in_process(torch, fa, data_path, phase5_s, tmp) -> dict:
    """Phase 13 (ii): RESUME_CELL (transformer-long b2 x S4096) flash fed from the token
    file through ``prefetch_to_device``: 6 steps straight through, then
    from the same init 3 steps, ``save_state``, ``restore_state`` into a
    fresh trainer and 3 more with the stream resumed at 3 (its main path:
    the counts set to 0 just before the straight run, read after the
    resumed one).  The resumed losses must equal steps 4-6 within
    LOSS_RTOL; the restored trainer's replays must launch FLASH_PER_STEP by
    the counters and by a profiler window, make no host sync in 3
    prefetch-fed replays, keep the device busy at least BUSY_MIN of the
    fed step, which must be within STEP_RTOL of replays on a batch already on
    the card: the median, over STEP_PAIRS pairs of 5-step blocks (resident,
    then fed), of each fed block's time over its resident block's."""
    from gpuschedule_tpu_torch.data import TokenFileDataset
    from gpuschedule_tpu_torch.parallel import ShardedTrainer
    from gpuschedule_tpu_torch.parallel.checkpoint import restore_state, save_state

    model, rows, seq = RESUME_CELL
    ds = TokenFileDataset(data_path, batch_size=rows, seq_len=seq)
    make = lambda: ShardedTrainer(model, batch_size=rows, seq_len=seq,  # noqa: E731
                                  flash_attn=True)
    torch.cuda.synchronize()
    fa.reset_launches()                           # the main path starts here
    straight_tr = make()
    straight = straight_tr.init(seed=0)
    losses = []
    for batch in _fed(ds, straight_tr, 0, 6):
        straight, loss = straight_tr.step(straight, batch)
        losses.append(loss)
    first_tr = make()
    first = first_tr.init(seed=0)
    resumed_losses = []
    for batch in _fed(ds, first_tr, 0, 3):
        first, loss = first_tr.step(first, batch)
        resumed_losses.append(loss)
    ckpt = save_state(first, os.path.join(tmp, "resume_ckpt"))
    del first, first_tr
    trainer = make()
    state = restore_state(trainer, ckpt)
    count = state.optimizer.count()
    for batch in _fed(ds, trainer, 3, 3):
        state, loss = trainer.step(state, batch)
        resumed_losses.append(loss)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)                  # ... and ends here
    losses = [x.item() for x in losses]
    resumed_losses = [x.item() for x in resumed_losses]
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed_losses[3:], losses[3:]))
    gap = _rel_l2(torch, state, straight)
    log(f"resume in process: straight {losses}, resumed {resumed_losses} (restored at "
        f"update {count}); steps 4-6 max rel {rel:.2e} (bound {LOSS_RTOL}), bit-equal "
        f"{resumed_losses[3:] == losses[3:]}; parameters' relative L2 gap after step 6 "
        f"{gap:.3e}")
    check(count == 3, f"the restored state made {count} updates, not 3")
    rel3 = max(abs(a - b) / abs(b) for a, b in zip(resumed_losses[:3], losses[:3]))
    check(rel3 < LOSS_RTOL, f"the first 3 steps {resumed_losses[:3]} differ from the straight "
                            f"run's {losses[:3]}")
    check(rel < LOSS_RTOL, f"resumed losses {resumed_losses[3:]} vs {losses[3:]}")
    check(all(math.isfinite(x) for x in losses + resumed_losses),
          f"non-finite losses: {losses}, {resumed_losses}")
    del straight, straight_tr

    # the restored trainer's replays, fed by prefetch: timing, sync, profile.  Each
    # fed block follows a block of replays on one batch already on the card (the
    # feed's first), and is held to it: phase 5 ran minutes earlier, the card's
    # clock moves by a few percent between phases and by 2-4% between blocks
    # the window's 2 steps, and 2 more for each window it may take again
    from gpuschedule_tpu_torch.profiler.harness import WINDOWS

    spare = 2 * (WINDOWS - 1)
    fed = _fed(ds, trainer, 6, 1 + STEP_PAIRS * 5 + 3 + 2 + spare + 1, epoch=0)
    resident = next(fed)
    blocks, resident_blocks = [], []
    for _ in range(STEP_PAIRS):
        for feed, times in ((itertools.repeat(resident), resident_blocks), (fed, blocks)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                state, loss = trainer.step(state, next(feed))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / 5)
    step_s = statistics.median(blocks)
    resident_s = statistics.median(resident_blocks)
    pair_rel = [f / r - 1 for f, r in zip(blocks, resident_blocks)]
    del resident
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, loss = trainer.step(state, next(fed))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    before = dict(fa.LAUNCHES)
    prof = profile_steps(torch, trainer, state, None, feed=fed,
                         kernels=[KERNELS[name][0] for name in KERNELS])
    check("device_ms_per_step" in prof, f"prefetch-fed step profile: {prof}")
    window = {name: (fa.LAUNCHES[name] - before[name]) / prof["steps_run"] for name in KERNELS}
    seen = {name: prof["launches_per_step"][KERNELS[name][0]] for name in KERNELS}
    busy = prof["device_ms_per_step"] / (step_s * 1e3)
    state, loss = trainer.step(state, next(fed))
    for _ in range(spare - (prof["steps_run"] - 2)):  # what the windows taken left over
        next(fed)
    check(next(fed, None) is None, "the feed held more batches than the steps took")
    step_rel = statistics.median(pair_rel)
    log(f"prefetch-fed replays of the restored trainer: {step_s * 1e3:.3f} ms/step "
        f"(blocks {[round(b * 1e3, 4) for b in blocks]}) against its replays on a batch on "
        f"the card between them, {resident_s * 1e3:.3f} ms (blocks "
        f"{[round(b * 1e3, 4) for b in resident_blocks]}; each fed block over the one "
        f"before it {[f'{r:+.2%}' for r in pair_rel]}, median {step_rel:+.2%}, bound "
        f"±{STEP_RTOL:.0%}), and phase 5's {phase5_s * 1e3:.3f} ms "
        f"({(step_s - phase5_s) / phase5_s:+.2%}); device busy {busy:.3f} (bound "
        f"{BUSY_MIN}); launches a step: counters {window}, profiler {seen}")
    check(seen == window == FLASH_PER_STEP,
          f"restored trainer: the profiler's kernels {seen}, the counters' {window}, expected "
          f"{FLASH_PER_STEP}")
    check(busy >= BUSY_MIN, f"the device is busy {busy:.3f} of the prefetch-fed step")
    check(abs(step_rel) <= STEP_RTOL,
          f"the prefetch-fed step is {step_rel:+.2%} off the resident batch's (median of "
          f"{STEP_PAIRS} block pairs)")
    check(all(launches[name] >= 12 * FLASH_PER_STEP[name] for name in KERNELS),
          f"the resume path did not run every kernel a step: {launches} over 12 steps")
    check(math.isfinite(loss.item()), "non-finite loss after the fed replays")
    del state, trainer
    torch.cuda.empty_cache()
    return {"losses": losses, "resumed_losses": resumed_losses, "resumed_rel": rel,
            "bit_equal": resumed_losses[3:] == losses[3:], "param_rel_l2": gap,
            "restored_count": count, "launches": launches, "steps": 12,
            "fed_step_ms": step_s * 1e3, "fed_blocks_ms": [b * 1e3 for b in blocks],
            "resident_step_ms": resident_s * 1e3,
            "resident_blocks_ms": [b * 1e3 for b in resident_blocks], "fed_vs_resident": step_rel,
            "fed_vs_resident_pairs": pair_rel,
            "phase5_step_ms": phase5_s * 1e3, "fed_vs_phase5": (step_s - phase5_s) / phase5_s,
            "busy_share_of_step": busy, "launches_per_replay": window, "profile": prof}


def _train_cli(args, env_extra=None):
    """``python -m gpuschedule_tpu_torch train`` with ``args``; its exit
    code, its stdout's last JSON line and its stderr."""
    model, batch, seq = RESUME_CELL
    cmd = [sys.executable, "-m", "gpuschedule_tpu_torch", "train", "--model", model,
           "--batch-size", str(batch), "--seq-len", str(seq), "--flash-attn", *args]
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish_cli(proc, what):
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    for text in err.splitlines():
        print(f"train ({what}): {text}", file=sys.stderr)
    lines = out.strip().splitlines()
    log(f"train ({what}): exit {proc.returncode}; {lines[-1] if lines else 'no output'}")
    check(proc.returncode == 0 and bool(lines), f"train ({what}) exited {proc.returncode}")
    return json.loads(lines[-1]), err


def resume_cli(data_path, tmp, reference) -> dict:
    """Phase 13 (iii): ``train --data F --steps 3 --ckpt C``, then ``--steps
    3 --restore C`` and, beside it, a restore with ``--seed 1`` under
    ``GSTPU_TRACE=1``: both exit 0, ``checkpoint`` is C and its sidecar has
    the JAX CLI's keys, ``resumed_at_step`` is 3, the resumed first and
    last losses are (ii)'s steps 4 and 6 within LOSS_RTOL, the seed-1
    restore warns of the drift and prints a spans line with a
    ``train.step`` a step."""
    ckpt = os.path.join(tmp, "cli_ckpt")
    t0 = time.perf_counter()
    saved, _ = _finish_cli(_train_cli(["--data", data_path, "--steps", "3", "--ckpt", ckpt]),
                           "save")
    procs = (_train_cli(["--data", data_path, "--steps", "3", "--restore", ckpt]),
             _train_cli(["--data", data_path, "--steps", "3", "--restore", ckpt, "--seed", "1"],
                        {"GSTPU_TRACE": "1"}))
    resumed, _ = _finish_cli(procs[0], "restore")
    drift, err = _finish_cli(procs[1], "restore, --seed 1, GSTPU_TRACE=1")
    with open(ckpt + ".datastream.json") as f:
        sidecar = json.load(f)
    warned = [x for x in err.splitlines() if x.startswith("WARNING: data stream differs")]
    spans = [json.loads(x)["spans"] for x in err.splitlines() if x.startswith('{"spans"')]
    want = reference["losses"]
    rel = max(abs(resumed["first_loss"] - want[3]) / abs(want[3]),
              abs(resumed["last_loss"] - want[5]) / abs(want[5]))
    log(f"train CLI resume: checkpoint {saved['checkpoint']}, sidecar {sidecar}; resumed at "
        f"{resumed['resumed_at_step']}: first {resumed['first_loss']} last "
        f"{resumed['last_loss']} vs in-process steps 4 and 6 {want[3]} {want[5]} (max rel "
        f"{rel:.2e}); drift warning {warned}; spans {spans}")
    check(saved["checkpoint"] == ckpt and saved["resumed_at_step"] is None,
          f"the saving run's summary: {saved}")
    check(set(sidecar) == {"seed", "batch_size", "seq_len", "host_shard", "data"},
          f"the sidecar's keys: {sorted(sidecar)}")
    check(resumed["resumed_at_step"] == 3 and resumed["checkpoint"] is None,
          f"the resumed run's summary: {resumed}")
    check(rel < LOSS_RTOL, f"the CLI's resumed losses are {rel:.2e} off (ii)'s")
    check(len(warned) == 1 and "seed: 0 -> 1" in warned[0],
          f"the --seed 1 restore did not warn of the drift: {err[-400:]}")
    check(len(spans) == 1 and spans[0]["train.step"]["count"] == 3,
          f"the traced run's spans line: {spans}")
    return {"saved": saved, "resumed": resumed, "seed1": drift, "sidecar_keys": sorted(sidecar),
            "resumed_rel": rel, "warning": warned[0], "spans": spans[0],
            "phase_s": time.perf_counter() - t0}


def _filesystem(path) -> str:
    """The type of the filesystem that holds ``path`` (``stat -f``: a
    statfs of the path itself)."""
    res = subprocess.run(["stat", "-f", "-c", "%T", path], capture_output=True, text=True)
    return res.stdout.strip() if res.returncode == 0 else f"unknown ({res.stderr.strip()})"


def _save_restore(torch, state, tokens, base, want) -> dict:
    """One timed ``save_state`` into a new directory under ``base`` (its
    filesystem and free space logged first, removed after) and one timed
    ``restore_state`` onto a new trainer; the restored trainer's next loss
    on ``tokens``, then everything of it dropped."""
    from gpuschedule_tpu_torch.parallel import ShardedTrainer
    from gpuschedule_tpu_torch.parallel.checkpoint import restore_state, save_state

    model, batch, seq = CKPT_MODEL
    tmp = tempfile.mkdtemp(prefix="gstpu_ckpt_", dir=base)
    try:
        free = shutil.disk_usage(tmp).free
        fs = _filesystem(tmp)
        log(f"checkpoint cost: {model} into {tmp}: {fs}, {free / 1e9:.1f} GB free")
        check(free > 1.5 * want, f"{free / 1e9:.1f} GB free in {tmp} where the checkpoint "
                                 f"needs {want / 1e9:.2f}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_state(state, os.path.join(tmp, "ck"))
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))
        trainer = ShardedTrainer(model, batch_size=batch, seq_len=seq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = restore_state(trainer, path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not os.path.exists(tmp), f"{tmp} was not removed")
    loss = trainer.step(restored, tokens)[1].item()
    del restored, trainer
    log(f"checkpoint cost ({fs}): save {save_s:.3f} s ({nbytes:,} bytes, "
        f"{nbytes / save_s / 1e9:.3f} GB/s), restore {restore_s:.3f} s "
        f"({nbytes / restore_s / 1e9:.3f} GB/s; the trainer's init and the read, which the "
        f"page cache may serve); the restored trainer's next loss {loss}")
    check(nbytes >= want, f"the checkpoint holds {nbytes:,} bytes, under {want:,}")
    return {"dir": base, "filesystem": fs, "free_bytes": free, "bytes": nbytes,
            "save_s": save_s, "restore_s": restore_s, "save_gb_per_s": nbytes / save_s / 1e9,
            "restore_gb_per_s": nbytes / restore_s / 1e9, "next_loss": loss}


def ckpt_cost(torch) -> dict:
    """Phase 13 (iv): ``save_state`` and ``restore_state`` of the
    flagship's state (CKPT_MODEL, 2 steps so adamw's moments exist) into a
    temporary directory on the machine's temporary filesystem (TMPDIR) and
    one in this checkout's (``_save_restore``): seconds, bytes written (at
    least CKPT_BYTES_PER_PARAM a parameter) and GB/s; each restored
    trainer's next loss must equal the unrestored trainer's within
    LOSS_RTOL, and the memory of all of them must be given back."""
    import gc

    from gpuschedule_tpu_torch.parallel import ShardedTrainer

    model, batch, seq = CKPT_MODEL
    torch.cuda.synchronize()
    held0 = torch.cuda.memory_allocated()
    trainer = ShardedTrainer(model, batch_size=batch, seq_len=seq)
    state = trainer.init(seed=0)
    tokens = trainer.make_batch(seed=0)
    for _ in range(2):
        state = trainer.step(state, tokens)[0]
    n_params = sum(p.numel() for p in state.model.parameters())
    want = CKPT_BYTES_PER_PARAM * n_params
    log(f"checkpoint cost: {model} b{batch} S{seq} after 2 steps, {n_params:,} parameters, "
        f"{want / 1e9:.3f} GB at {CKPT_BYTES_PER_PARAM} B/param")
    rows = [_save_restore(torch, state, tokens, base, want)
            for base in (tempfile.gettempdir(), str(ROOT))]
    ref = trainer.step(state, tokens)[1].item()
    del state, trainer, tokens
    gc.collect()
    torch.cuda.empty_cache()
    kept_mib = (torch.cuda.memory_allocated() - held0) / 2**20
    rels = [abs(r["next_loss"] - ref) / abs(ref) for r in rows]
    log(f"checkpoint cost: the unrestored trainer's next loss {ref}, the restored ones' "
        f"{[r['next_loss'] for r in rows]} (rel {rels}); {kept_mib:.1f} MiB still allocated "
        f"after (bound {PROFILE_KEPT_MIB} MiB)")
    check(max(rels) < LOSS_RTOL, "a restored trainer's next loss is not the unrestored one's")
    check(kept_mib <= PROFILE_KEPT_MIB, "the checkpoint phase keeps a trainer's memory")
    return {"model": model, "batch": batch, "seq": seq, "params": n_params,
            "bytes_at_12_per_param": want, "rows": rows, "next_loss_unrestored": ref,
            "next_loss_rel": rels, "kept_mib": kept_mib}


def ckpt_phase(torch, fa, smi, phase5_s) -> dict:
    """Phase 13: data and checkpoints.  (i) a token file written by the
    port's ``TokenFileDataset.write`` (uint16, transformer-long's vocab,
    DATA_BATCHES batches of 2 x 4096, numpy seed 13); (ii) the resume in
    process (``resume_in_process``); (iii) through the CLI
    (``resume_cli``); (iv) the checkpoint's cost at the flagship's state
    (``ckpt_cost``)."""
    import numpy as np

    from gpuschedule_tpu_torch.data import TokenFileDataset
    from gpuschedule_tpu_torch.models import MODEL_CONFIGS

    t0 = time.perf_counter()
    model, batch, seq = RESUME_CELL
    with tempfile.TemporaryDirectory(prefix="gstpu_data_") as tmp:
        vocab = MODEL_CONFIGS[model].vocab
        tokens = np.random.default_rng(13).integers(0, vocab, size=DATA_BATCHES * batch * seq)
        data = str(TokenFileDataset.write(tokens, os.path.join(tmp, "tokens.bin")))
        check(len(TokenFileDataset(data, batch_size=batch, seq_len=seq)) == DATA_BATCHES,
              "the token file does not hold DATA_BATCHES batches")
        log(f"phase 13 data: {os.path.getsize(data):,} bytes, {DATA_BATCHES} batches of "
            f"{batch} x {seq} uint16 tokens below {vocab}")
        inproc = resume_in_process(torch, fa, data, phase5_s, tmp)
        cli = resume_cli(data, tmp, inproc)
    cost = ckpt_cost(torch)
    return {"card": smi, "in_process": inproc, "cli": cli, "cost": cost,
            "phase_s": time.perf_counter() - t0}


def sdpa_backward_ms(torch, q, k, v, g, ms, causal: bool = True) -> float:
    """ms of SDPA's flash backward (``aten._scaled_dot_product_flash_attention
    _backward``: dq, dk and dv in one call, bf16 out) on (B, S, H, D) q, k,
    v and the cotangent g, from its forward op's own out and lse: the
    yardstick for K2 and K3 together, which the port never calls."""
    qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, g))
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = \
        torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, causal)[:8]
    return ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        gt, qt, kt, vt, out, lse, cum_q, cum_k, max_q, max_k, 0.0, causal, seed, offset), 10)


def _sha256(torch, tensors) -> str:
    """The SHA-256 of the tensors' bytes, in order (a device-to-host copy)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_worker(rank: int, n: int, store: str, out_dir: str, checks: str, *args) -> None:
    """One of ``n`` processes time-sliced on the one card: a gloo group
    (``all_reduce`` and ``broadcast`` of CUDA tensors staged through host
    memory: NCCL takes one rank a card), then ``checks`` (the name of a
    function of this script) with ``args``; writes its findings to
    ``rank<rank>.json``."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n)
    try:
        found = globals()[checks](torch, dist, *args)
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(found))


def spawn_ranks(n: int, timeout_s: float, checks: str, *args):
    """([each rank's findings], seconds): :func:`rank_worker` on ``n``
    spawned processes; a rank that fails or outlives ``timeout_s`` fails
    the run."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(rank_worker, nprocs=n, join=False, start_method="spawn",
                                 args=(n, os.path.join(tmp, "store"), tmp, checks, *args))
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                check(time.monotonic() < deadline, f"the ranks did not finish in {timeout_s} s")
        except mp.ProcessRaisedException as e:
            raise SmokeFailure(f"a rank failed: {e}") from None
        except mp.ProcessExitedException as e:
            raise SmokeFailure(f"a rank exited: {e}") from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        seconds = time.perf_counter() - t0
        return [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(n)], seconds


def grad_errors(torch, grads, ref, shard=None, l2=False) -> dict:
    """Each gradient's max abs error over the largest entry of its
    reference (``shard(name, ref)``: the slice a rank holds, by default
    all of it), or with ``l2`` its relative L2 error; the key bias, whose
    exact gradient is 0 (softmax ignores a constant added to a row's
    scores), against the largest of the model's."""
    size = (lambda t: t.float().norm().item()) if l2 else (lambda t: t.abs().max().item())
    top = max(size(r) for r in ref.values())
    out = {}
    for name, g in grads.items():
        r = ref[name] if shard is None else shard(name, ref[name])
        scale = top if name.endswith("attn.key.bias") else size(r)
        out[name] = size(g.float() - r.float()) / scale
    return out


def _one_rank_moe(torch, model, seq):
    """Block 0's MoE module of the one-rank model of ``model`` from seed 0."""
    from gpuschedule_tpu_torch.parallel import Mesh, ShardedTrainer

    one = Mesh({"pp": 1, "dp": 1, "sp": 1, "tp": 1}, torch.device("cuda", 0))
    return ShardedTrainer(model, one, seq_len=seq).init(seed=0).model.blocks[0].moe


def moe_grad_errors(torch, dist, trainer, moe, x, one_moe) -> dict:
    """A tp rank's MoE module (``moe``, routing the global batch over the
    trainer's mesh) against the one-rank module ``one_moe`` on the same
    global input ``x`` and cotangent: the gradients of ``sum(y·g) + aux``
    with respect to each parameter (the rank's summed over the data group,
    held slice by slice) and to the input (the rank's rows), each as
    :func:`grad_errors` measures.  Every rank calls it."""
    from gpuschedule_tpu_torch.parallel.tp import param_partition_spec

    x = x.to(trainer.device)
    g = torch.randn(x.shape, generator=torch.Generator(device=x.device).manual_seed(7),
                    device=x.device).to(x.dtype)
    rows = slice(trainer.row0, trainer.row0 + trainer.rows)
    grads = []
    for module, xs, gs in ((one_moe, x, g), (moe, x[rows], g[rows])):
        xs = xs.detach().clone().requires_grad_(True)
        module.zero_grad(set_to_none=True)
        y, aux = module(xs)
        ((y.float() * gs.float()).sum() + aux).backward()
        grads.append({"input": xs.grad, **{n: p.grad.detach().clone()
                                           for n, p in module.named_parameters()}})
    ref, mine = grads
    for name, t in mine.items():
        if name != "input":
            dist.all_reduce(t, group=trainer.mesh.data_group)
    ref["input"] = ref["input"][rows]

    def shard(name, r):
        dim = None if name == "input" else param_partition_spec(f"blocks.0.moe.{name}", r.dim())
        return trainer.tp.shard(r, dim)
    return grad_errors(torch, mine, ref, shard, l2=True)


def _one_rank_grads(torch, model, batch, seq, flash):
    """(loss, gradients) of the one-rank trainer of ``model`` from seed 0
    on its seed-0 global batch: the reference a rank's gradients are held
    to."""
    from gpuschedule_tpu_torch.parallel import Mesh, ShardedTrainer

    one = Mesh({"pp": 1, "dp": 1, "sp": 1, "tp": 1}, torch.device("cuda", 0))
    trainer = ShardedTrainer(model, one, batch_size=batch, seq_len=seq, flash_attn=flash)
    state = trainer.init(seed=0)
    state.optimizer.zero_grad()
    loss = trainer.loss_and_grads(state, trainer.make_batch(seed=0)).item()
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    return loss, grads


def _tp_checks(torch, dist, ref_path) -> dict:
    """Phase 15 on one rank (:func:`rank_worker`): ``make_mesh(dp=2,
    tp=2)`` and TP_CELLS' trainers from seed 0 on the one-rank trainers'
    global batches, TP_STEPS steps each.  Before the steps, on the dp
    column 0 ranks, the gradients of one backward against the one-rank
    trainer's, slice by slice (:func:`grad_errors`)."""
    from gpuschedule_tpu_torch.convert import unshard_state_dict
    from gpuschedule_tpu_torch.parallel import ShardedTrainer, make_mesh
    from gpuschedule_tpu_torch.parallel.tp import param_partition_spec

    ref = torch.load(ref_path)
    fa = importlib.import_module("gpuschedule_tpu_torch.ops.flash_attention")
    mesh = make_mesh(dp=2, tp=2)
    found = {"coords": [mesh.coordinate("dp"), mesh.coordinate("tp")]}
    for model, batch, seq, flash in TP_CELLS:
        trainer = ShardedTrainer(model, mesh, batch_size=batch, seq_len=seq, flash_attn=flash)
        state = trainer.init(seed=0)
        data = trainer.make_batch(seed=0)
        cell = {"local_batch": list(data.shape)}
        if trainer.cfg.n_experts:
            cell["routes"] = _tp_routes(torch, trainer, state, ref)
        state.optimizer.zero_grad()
        cell["grad_loss"] = trainer.loss_and_grads(state, data).item()
        if trainer.cfg.n_experts:
            # a route flips on a bf16 ulp of the block's input (tp's g sums
            # round other than one GEMM does), and a flipped token moves the
            # whole model's gradients: the MoE's are held where the input is
            # the one-rank model's
            errs = moe_grad_errors(torch, dist, trainer, state.model.blocks[0].moe, ref["x"],
                                   _one_rank_moe(torch, model, seq))
            worst = max(errs, key=errs.get)
            cell["grad_err"] = {"max": errs[worst], "worst": worst, "where": "block 0's MoE"}
        elif mesh.coordinate("dp") == 0:  # the data group's sum: the same on dp 1
            _, one = _one_rank_grads(torch, model, batch, seq, flash)
            grads = {n: p.grad for n, p in state.model.named_parameters()}
            errs = grad_errors(torch, grads, one, lambda name, r: trainer.tp.shard(
                r, param_partition_spec(name, r.dim())), l2=True)
            worst = max(errs, key=errs.get)
            cell["grad_err"] = {"max": errs[worst], "worst": worst}
            del one, grads
        state.optimizer.zero_grad()
        torch.cuda.synchronize()
        fa.reset_launches()                       # this cell's path starts here
        losses, step_ms = [], []
        for _ in range(TP_STEPS):
            t0 = time.perf_counter()
            state, loss = trainer.step(state, data)
            losses.append(loss.item())            # a readback: the step is done
            step_ms.append((time.perf_counter() - t0) * 1e3)
        cell["launches"] = dict(fa.LAUNCHES)      # ... and ends here
        cell.update(losses=losses, step_ms=step_ms, peak_gib=torch.cuda.max_memory_allocated()
                    / 2**30)
        named = dict(state.model.named_parameters())
        whole = unshard_state_dict({n: p.detach() for n, p in named.items()}, trainer.tp)
        cell["whole_sha256"] = _sha256(torch, whole.values())
        cell["local_params"] = sum(p.numel() for p in named.values())
        found[model] = cell
        del state, trainer, data, whole, named
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return found


def _tp_routes(torch, trainer, state, ref) -> dict:
    """Block 0's routes on this rank, given the one-rank model's input to
    that block (``ref["x"]``): each token's slot at each of this rank's
    experts (-1 where it is not there), against the one-rank module's;
    a token whose top-k experts differ is a flip, named with the one-rank
    router's logit gap between its k-th and (k+1)-th expert and the two
    routers' largest logit difference on it."""
    moe = state.model.blocks[0].moe
    rows = slice(trainer.row0, trainer.row0 + trainer.rows)
    x = ref["x"].to(trainer.device)[rows]
    with torch.no_grad():
        dispatch, _, _ = moe.route(x)
        logits = moe.router(x.float()).reshape(-1, moe.n_experts)
    cap = dispatch.shape[-1]
    pos = (dispatch.float() * torch.arange(1, cap + 1, device=x.device)).sum(-1) - 1
    t0, t1 = rows.start * x.shape[1], rows.stop * x.shape[1]
    experts = slice(moe.e0, moe.e0 + moe.local_experts)
    ref_pos = ref["pos"].to(x.device)[t0:t1, experts]
    ref_logits = ref["logits"].to(x.device)[t0:t1]
    k = moe.top_k
    mine = logits.topk(k, dim=-1).indices.sort(dim=-1).values
    theirs = ref_logits.topk(k, dim=-1).indices.sort(dim=-1).values
    flips = []
    for t in (mine != theirs).any(dim=-1).nonzero().flatten().tolist():
        srt = ref_logits[t].sort(descending=True).values
        flips.append({"token": t0 + t, "gap": (srt[k - 1] - srt[k]).item(),
                      "drift": (logits[t] - ref_logits[t]).abs().max().item()})
    return {"slots_equal": bool(torch.equal(pos, ref_pos)), "routed": int((pos >= 0).sum()),
            "slot_differences": int((pos != ref_pos).sum()), "flips": flips,
            "logit_drift": (logits - ref_logits).abs().max().item()}


def tp_reference(torch) -> dict:
    """Phase 15's reference for the MoE routes: TP_CELLS' MoE model on one
    rank from seed 0 on its batch: block 0's MoE input, each token's slot
    at each expert (-1 where it is not there) and the router's logits."""
    from gpuschedule_tpu_torch.models import MODEL_CONFIGS
    from gpuschedule_tpu_torch.parallel import ShardedTrainer

    model, batch, seq, flash = next(c for c in TP_CELLS if MODEL_CONFIGS[c[0]].n_experts)
    trainer = ShardedTrainer(model, batch_size=batch, seq_len=seq, flash_attn=flash)
    state = trainer.init(seed=0)
    moe = state.model.blocks[0].moe
    grab = {}
    hook = moe.register_forward_pre_hook(lambda mod, args: grab.setdefault("x", args[0]))
    with torch.no_grad():
        state.model(trainer.make_batch(seed=0))
        hook.remove()
        dispatch, _, _ = moe.route(grab["x"])
        logits = moe.router(grab["x"].float()).reshape(-1, moe.n_experts)
    cap = dispatch.shape[-1]
    pos = (dispatch.float() * torch.arange(1, cap + 1, device=dispatch.device)).sum(-1) - 1
    out = {"x": grab["x"].cpu(), "pos": pos.cpu(), "logits": logits.cpu()}
    del state, trainer, dispatch, grab
    torch.cuda.empty_cache()
    return out


def kernels_at(torch, fa, dev, shape, ms, peaks, F, seed, what) -> dict:
    """K1-K3 at ``shape`` (bf16, causal) against their plain versions within
    phase 3's bounds, then timed (CUDA events) beside their plain versions,
    their bounds, SDPA's forward (K1's yardstick) and SDPA's flash backward
    (K2's and K3's, dq, dk and dv in one call); ``what`` names the shape."""
    from gpuschedule_tpu_torch.profiler import time_callable
    from gpuschedule_tpu_torch.tools.roofline import attention_cost, bound

    b, s, h, d = shape
    parity = kernel_parity(torch, fa, dev, shape, torch.bfloat16, True, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = fa.attention_delta(out, g)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal=True),
                      lambda: fa.flash_fwd_plain(q, k, v, True)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=True),
                         lambda: fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, True)),
        "flash_bwd_dkdv": (lambda: fa.flash_bwd_dkdv(q, k, v, g, lse, delta, causal=True),
                           lambda: fa.flash_bwd_dkdv_plain(q, k, v, g, lse, delta, True)),
    }
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_fwd = ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    sdpa_bwd = sdpa_backward_ms(torch, q, k, v, g, ms)
    kernels = {}
    for name, (kernel, plain) in calls.items():
        flops, nbytes = attention_cost(b, s, h, d, True, 2, name)
        bound_ms, bound_by = bound(flops, nbytes, peaks)
        kernels[name] = {"shape": list(shape), "max_abs_err": parity["abs"][name],
                         "tile_rel_err": parity["tile"][name], "ms": ms(kernel),
                         "plain_ms": time_callable(plain, iters=2, warmup=1, device=dev) * 1e3,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": sdpa_fwd if name == "flash_fwd" else sdpa_bwd}
        log(f"time {name} {shape} bf16 causal ({what}): "
            f"{kernels[name]['ms']:.4f} ms (plain {kernels[name]['plain_ms']:.3f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by})")
    pair = kernels["flash_bwd_dq"]["ms"] + kernels["flash_bwd_dkdv"]["ms"]
    log(f"time {shape}: sdpa forward {sdpa_fwd:.4f} ms; K2 + K3 together {pair:.4f} ms vs "
        f"sdpa flash backward (dq, dk, dv in one call) {sdpa_bwd:.4f} ms")
    return kernels


def mesh_ranks(torch, fa, dev, ms, peaks, F):
    """Phases 15 and 16 up to their ranks: K1-K3 at the shapes a tp rank
    (TP_SHAPE: transformer-long's 8 heads over tp = 2, one row a dp rank)
    and a pipeline stage (PP_SHAPE) give them, against their plain versions
    within phase 3's bounds, timed beside their bounds, SDPA's forward and
    SDPA's flash backward (:func:`kernels_at`); phase 15's MoE reference;
    then MESH_RANKS processes time-sliced on the card (:func:`rank_worker`)
    run :func:`_tp_checks` and then :func:`_pp_checks`, in one spawn.
    Returns (the tp shape's kernels, the pp shape's, each rank's findings,
    the ranks' seconds)."""
    tp_kernels = kernels_at(torch, fa, dev, TP_SHAPE, ms, peaks, F, 800, "a tp rank's heads")
    pp_kernels = kernels_at(torch, fa, dev, PP_SHAPE, ms, peaks, F, 900,
                            "a pipeline stage's rows")
    ref = tp_reference(torch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save(ref, ref_path)
        found, ranks_s = spawn_ranks(MESH_RANKS, MESH_TIMEOUT_S, "_mesh_checks", ref_path)
    log(f"phases 15 and 16: {ranks_s:.1f} s for the ranks")
    return tp_kernels, pp_kernels, found, ranks_s


def _mesh_checks(torch, dist, ref_path) -> dict:
    """One rank of phases 15 and 16: :func:`_tp_checks`, then
    :func:`_pp_checks`, the trainers of one freed before the next."""
    tp = _tp_checks(torch, dist, ref_path)
    torch.cuda.empty_cache()
    return {"tp": tp, "pp": _pp_checks(torch, dist)}


def tp_phase(smi, first_losses, kernels, found) -> dict:
    """Phase 15: tensor parallelism with ep-over-tp on the one card, from
    :func:`mesh_ranks`: MESH_RANKS processes time-sliced on the card ran
    TP_CELLS on a dp 2 x tp 2 mesh: each first
    loss within LOSS_RTOL of the one-rank trainer's (``first_losses``, the
    earlier phases' steps from the same seed on the same batch), the
    losses finite and falling, the parameters gathered over tp the same
    on every rank (one SHA-256), K1-K3 FLASH_PER_STEP a step on every rank
    of the flash cell by the counters, and for the MoE block 0's slots
    those of the one-rank model given its input (a flip at a near tie is
    named with its gap).  Each rank's gradients of one backward before
    the steps are held to the one-rank trainer's within TP_GRAD_RTOL,
    relative L2 (a split parameter slice by slice, a replicated one whole; the MoE's
    at block 0's module on the one-rank model's input), a check that adam's
    updates cannot give: a gradient off by a constant factor moves no
    loss.  The step times are not a tp speed."""
    found = [f["tp"] for f in found]
    check(sorted(tuple(f["coords"]) for f in found) == [(0, 0), (0, 1), (1, 0), (1, 1)],
          f"tp coordinates {[f['coords'] for f in found]}")
    cells = {}
    for model, batch, seq, flash in TP_CELLS:
        per_rank = [f[model] for f in found]
        first = per_rank[0]["losses"][0]
        rel = abs(first - first_losses[model]) / abs(first_losses[model])
        hashes = {c["whole_sha256"] for c in per_rank}
        log(f"tp {model} b{batch} S{seq}{' flash' if flash else ''} on dp 2 x tp 2: losses "
            f"{per_rank[0]['losses']} (first vs the one-rank trainer's {first_losses[model]:.6f}: "
            f"rel {rel:.2e}, bound {LOSS_RTOL}); step ms {per_rank[0]['step_ms']} ({TP_LABEL}); "
            f"peak {max(c['peak_gib'] for c in per_rank):.2f} GiB a rank; local batch "
            f"{per_rank[0]['local_batch']}; the gathered parameters' digests {len(hashes)}")
        check(all(c["losses"] == per_rank[0]["losses"] for c in per_rank),
              f"tp {model}: the ranks' losses differ")
        check(all(math.isfinite(x) for x in per_rank[0]["losses"])
              and per_rank[0]["losses"][-1] < per_rank[0]["losses"][0],
              f"tp {model}: the losses are not finite and falling: {per_rank[0]['losses']}")
        check(rel < LOSS_RTOL, f"tp {model}: the first loss disagrees with the one-rank trainer's")
        check(len(hashes) == 1, f"tp {model}: the gathered parameters differ between ranks")
        grad_errs = [c["grad_err"] for c in per_rank if "grad_err" in c]
        log(f"tp {model}: gradients of one backward against the one-rank trainer's, slice by "
            f"slice (relative L2): {grad_errs}")
        check(len(grad_errs) >= 2 and all(e["max"] < TP_GRAD_RTOL for e in grad_errs),
              f"tp {model}: a gradient disagrees with the one-rank trainer's: {grad_errs}")
        check(all(abs(c["grad_loss"] - c["losses"][0]) <= 1e-6 * abs(c["losses"][0])
                  for c in per_rank),
              f"tp {model}: the gradient pass's loss is not the first step's")
        cell = {"model": model, "batch": batch, "seq": seq, "flash": flash,
                "losses": per_rank[0]["losses"], "one_rank_first_loss": first_losses[model],
                "first_loss_rel": rel, "grad_err": grad_errs,
                "step_ms": [c["step_ms"] for c in per_rank],
                "step_ms_label": TP_LABEL, "local_batch": per_rank[0]["local_batch"],
                "local_params": [c["local_params"] for c in per_rank],
                "peak_gib": [c["peak_gib"] for c in per_rank]}
        if flash:
            per_step = [{n: c["launches"][n] / TP_STEPS for n in KERNELS} for c in per_rank]
            log(f"tp {model}: launches a step on each rank by the counters {per_step}")
            check(all(p == FLASH_PER_STEP for p in per_step),
                  f"tp {model}: K1-K3 launched {per_step} a step, not {FLASH_PER_STEP}")
            cell["launches_per_step"] = per_step
        if "routes" in per_rank[0]:
            routes = [c["routes"] for c in per_rank]
            flips = [fl for r in routes for fl in r["flips"]]
            log(f"tp {model} block 0 routes on each rank against the one-rank model's: "
                f"{json.dumps(routes)}")
            check(all(r["routed"] > 0 for r in routes), f"tp {model}: a rank routed nothing")
            check(all(fl["gap"] <= max(ROUTE_GAP, 2 * fl["drift"]) for fl in flips),
                  f"tp {model}: a route differs where the top-k logits do not nearly tie: "
                  f"{flips}")
            check(bool(flips) or all(r["slots_equal"] for r in routes),
                  f"tp {model}: the slots differ with no route flipped")
            cell["routes"] = routes
        cells[model] = cell
    return {"card": smi, "mesh": {"pp": 1, "dp": 2, "sp": 1, "tp": 2}, "ranks": MESH_RANKS,
            "transport": "gloo, CUDA tensors staged through host memory", "label": TP_LABEL,
            "kernels": kernels, "cells": cells}


def host_launch_calls(fn) -> dict:
    """{runtime call: count} of the host's calls that launch device work
    (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaGraphLaunch``, ...) in
    one profiler window of one call of ``fn`` (``device_window`` with the
    host's records, less the window's own pads and marker).  The ranks
    step together, so the window is taken once and read for its host
    records alone: ranks time-sliced on the card drop the first device
    records of a window (ROADMAP Queue 3), the host's calls none."""
    from gpuschedule_tpu_torch.profiler import device_window
    from gpuschedule_tpu_torch.profiler.harness import PAD

    counts: dict = {}
    for rec in device_window(fn, 1, host=True, what="pp launch calls", check=False).host:
        if rec.name.startswith("cu") and "Launch" in rec.name:
            counts[rec.name] = counts.get(rec.name, 0) + 1
    check(counts.get("cudaLaunchKernel", 0) > PAD + 1,
          f"a window without the step's host launch calls: {counts}")
    counts["cudaLaunchKernel"] -= PAD + 1
    return counts


def _pp_checks(torch, dist) -> dict:
    """Phase 16 on one rank (:func:`rank_worker`): ``make_mesh(pp=2)``
    (dp 2) and PP_CELLS' pipelines from seed 0 on their seed-0 global
    batches.  First the eager pipeline: on the dp column 0 ranks (one a
    stage, the two at once) the loss and gradients of one backward against
    the one-rank computation: the whole model from the same seed, its
    blocks in sequence (``reference_loss``; for the MoE on each
    (microbatch, dp column) share, as the pipeline routes); PP_STEPS eager
    steps (``_eager_step``), the host's launch calls of one more, and the
    peak memory.  Then, from seed 0 again, the pipeline's own step, whose
    stage compute the card captures: PP_STEPS steps (a warm-up, the
    capture and its replay, a replay), K1-K3 by the counters, the host's
    launch calls of a replayed step, on the flash cell a profiler window
    of two steps, and the peak.  Then the gathered-sequence sp point
    (:func:`_sp_point`)."""
    from gpuschedule_tpu_torch.data import synthetic_lm_batches
    from gpuschedule_tpu_torch.models import build_model
    from gpuschedule_tpu_torch.parallel import PipelinedLM, make_mesh
    from gpuschedule_tpu_torch.parallel.pipeline import whole_names

    fa = importlib.import_module("gpuschedule_tpu_torch.ops.flash_attention")
    mesh = make_mesh(pp=2)
    found = {"coords": [mesh.coordinate("pp"), mesh.coordinate("dp")]}
    for model, batch, seq, m, schedule, flash in PP_CELLS:
        trainer = PipelinedLM(model, mesh, batch_size=batch, seq_len=seq, num_microbatches=m,
                              schedule=schedule, flash_attn=flash)
        state = trainer.init(seed=0)
        data = trainer.make_batch(seed=0)
        cell = {"local_batch": list(data.shape)}
        state.optimizer.zero_grad()
        cell["grad_loss"] = trainer.loss_and_grads(state, data).item()
        if mesh.coordinate("dp") == 0:  # the data group's sum: the same on dp 1
            with trainer.device:
                whole, cfg = build_model(model, attn_fn=trainer.attn_fn)
            whole.reset_parameters(torch.Generator(device=trainer.device).manual_seed(0))
            tokens = torch.from_numpy(next(synthetic_lm_batches(
                batch_size=batch, seq_len=seq, vocab=cfg.vocab, num_batches=1, seed=0)))
            ref = trainer.reference_loss(whole, tokens.long().to(trainer.device),
                                         per_microbatch=bool(cfg.n_experts))
            ref.backward()
            grads = whole_names({n: p.grad for n, p in state.model.named_parameters()},
                                trainer.first_layer)
            errs = grad_errors(torch, grads, {n: p.grad for n, p in whole.named_parameters()})
            worst = max(errs, key=errs.get)
            cell.update(reference_loss=ref.item(), grad_err={"max": errs[worst], "worst": worst})
            del whole, ref, grads
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()  # the eager pipeline's peak, not the reference's
        eager = []
        for _ in range(PP_STEPS):
            state, loss = trainer._eager_step(state, data)
            eager.append(loss.item())
        cell["eager_launch_calls"] = host_launch_calls(lambda: trainer._eager_step(state, data))
        cell.update(eager_losses=eager, eager_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = trainer.init(seed=0)
        torch.cuda.synchronize()
        fa.reset_launches()                       # this cell's path starts here
        losses, step_ms = [], []
        for _ in range(PP_STEPS):
            t0 = time.perf_counter()
            state, loss = trainer.step(state, data)
            losses.append(loss.item())            # a readback: the step is done
            step_ms.append((time.perf_counter() - t0) * 1e3)
        cell["launches"] = dict(fa.LAUNCHES)      # ... and ends here
        cell["graphs"] = sum(g is not None for g in trainer._graphs.values())
        cell["launch_calls"] = host_launch_calls(lambda: trainer.step(state, data))
        if flash:
            before = dict(fa.LAUNCHES)
            prof = profile_steps(torch, trainer, state, data, agree=ranks_agree(torch, dist),
                                 kernels=[KERNELS[name][0] for name in KERNELS])
            cell["window"] = {"counters": {n: (fa.LAUNCHES[n] - before[n]) / prof["steps_run"]
                                           for n in KERNELS},
                              "profiler": {n: prof.get("launches_per_step", {}).get(
                                  KERNELS[n][0]) for n in KERNELS}}
        cell.update(losses=losses, step_ms=step_ms,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        found[model] = cell
        del state, trainer, data
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    found["sp"] = _sp_point(torch)
    return found


def _sp_point(torch) -> dict:
    """The gathered-sequence sp path over the same four ranks: SP_CELL on
    dp 2 x sp 2 (``seq_shard`` without ``ring_attn``: dense attention over
    k and v gathered over sp), PP_STEPS steps from seed 0, then
    ``profile_model`` with ``sp=2`` at SP_KS into a temp ``CurveCache``
    (its ``model@sp2tp1`` entry)."""
    from gpuschedule_tpu_torch.parallel import ShardedTrainer, make_mesh
    from gpuschedule_tpu_torch.profiler import CurveCache, profile_model

    model, batch, seq = SP_CELL
    mesh = make_mesh(sp=2)
    trainer = ShardedTrainer(model, mesh, batch_size=batch, seq_len=seq, seq_shard=True)
    state = trainer.init(seed=0)
    data = trainer.make_batch(seed=0)
    losses, step_ms = [], []
    for _ in range(PP_STEPS):
        t0 = time.perf_counter()
        state, loss = trainer.step(state, data)
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"coords": [mesh.coordinate("dp"), mesh.coordinate("sp")],
           "attn": trainer.attn_fn.func.__name__, "local_batch": list(data.shape),
           "losses": losses, "step_ms": step_ms}
    del state, trainer, data
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "curves.json")
        curve = profile_model(model, ks=SP_KS, sp=2, batch_size=batch, seq_len=seq,
                              cache=CurveCache(path))
        if os.path.exists(path):
            out["curve"] = json.loads(Path(path).read_text())
    out["theta"] = list(curve.theta)
    return out


def pp_phase(smi, first_losses, kernels, found) -> dict:
    """Phase 16: the pipeline, and the gathered-sequence sp point, on the
    one card, from :func:`mesh_ranks`: MESH_RANKS processes time-sliced on
    the card (:func:`_pp_checks`) ran PP_CELLS on a pp 2 x dp 2 mesh at the zoo's full width: each first loss
    within LOSS_RTOL of the one-rank computation of the same parameters,
    the gradients of one backward within GRAD_TOL of its (each tensor's
    largest entry), the losses finite, falling and the same on every rank,
    and on the flash cell K1-K3 PP_FLASH_PER_STEP a step on every rank by
    the counters, equal to the profiler's; the pipeline's step with its
    stage compute captured: one graph set a rank, its losses within
    LOSS_RTOL of the eager pipeline's, fewer host launch calls in a step
    than the eager step's on every rank.  The gathered sp point: each
    first loss within LOSS_RTOL of the one-rank trainer's (``first_losses``),
    the losses finite and falling, the core ``gathered_attention``, the
    curve's key ``model@sp2tp1`` with SP_KS measured.  The step times are
    not a pp or sp speed."""
    found = [f["pp"] for f in found]
    check(sorted(tuple(f["coords"]) for f in found) == [(0, 0), (0, 1), (1, 0), (1, 1)],
          f"pp coordinates {[f['coords'] for f in found]}")
    cells = {}
    for model, batch, seq, m, schedule, flash in PP_CELLS:
        per_rank = [f[model] for f in found]
        losses = per_rank[0]["losses"]
        refs = [c for c in per_rank if "reference_loss" in c]
        check(len(refs) == 2, f"pp {model}: {len(refs)} ranks held the one-rank computation")
        rel = max(abs(c["grad_loss"] - c["reference_loss"]) / abs(c["reference_loss"])
                  for c in refs)
        grad_errs = [c["grad_err"] for c in refs]
        log(f"pp {model} b{batch} S{seq} M{m} {schedule}{' flash' if flash else ''} on pp 2 x "
            f"dp 2: losses {losses} (first vs the one-rank computation's "
            f"{refs[0]['reference_loss']:.6f}: rel {rel:.2e}, bound {LOSS_RTOL}); gradients "
            f"against it (max abs over each tensor's largest entry, a stage each) {grad_errs}; "
            f"step ms {per_rank[0]['step_ms']} ({PP_LABEL}); peak "
            f"{max(c['peak_gib'] for c in per_rank):.2f} GiB a rank; local batch "
            f"{per_rank[0]['local_batch']}")
        check(all(c["losses"] == losses for c in per_rank), f"pp {model}: the ranks' losses differ")
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"pp {model}: the losses are not finite and falling: {losses}")
        check(all(abs(c["grad_loss"] - losses[0]) <= 1e-6 * abs(losses[0]) for c in per_rank),
              f"pp {model}: the gradient pass's loss is not the first step's")
        check(rel < LOSS_RTOL, f"pp {model}: the first loss disagrees with the one-rank "
                               f"computation's")
        check(all(e["max"] < GRAD_TOL for e in grad_errs),
              f"pp {model}: a gradient disagrees with the one-rank computation's: {grad_errs}")
        eager = per_rank[0]["eager_losses"]
        cap_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, eager))
        bitwise = all(c["losses"] == c["eager_losses"] for c in per_rank)
        calls = [{"eager": sum(c["eager_launch_calls"].values()),
                  "captured": sum(c["launch_calls"].values())} for c in per_rank]
        log(f"pp {model}: the stage compute captured ({[c['graphs'] for c in per_rank]} "
            f"graph set(s) a rank): losses {losses} vs eager {eager} (max rel {cap_rel:.2e}, "
            f"bound {LOSS_RTOL}; bit-equal on every rank: {bitwise}); host launch calls in "
            f"one step, eager vs captured, a rank {calls} (rank 0: "
            f"{per_rank[0]['eager_launch_calls']} vs {per_rank[0]['launch_calls']}); peak "
            f"GiB a rank, eager {[round(c['eager_peak_gib'], 2) for c in per_rank]} vs "
            f"captured {[round(c['peak_gib'], 2) for c in per_rank]}")
        check(all(c["graphs"] == 1 for c in per_rank),
              f"pp {model}: the stage compute was not captured on every rank")
        check(cap_rel < LOSS_RTOL, f"pp {model}: the captured pipeline's losses disagree with "
                                   f"the eager pipeline's")
        check(all(c["captured"] < c["eager"] for c in calls),
              f"pp {model}: a captured step made no fewer host launch calls than an eager one: "
                 f"{calls}")
        cell = {"model": model, "batch": batch, "seq": seq, "microbatches": m,
                "schedule": schedule, "flash": flash, "losses": losses,
                "reference_loss": refs[0]["reference_loss"], "first_loss_rel": rel,
                "grad_err": grad_errs, "step_ms": [c["step_ms"] for c in per_rank],
                "step_ms_label": PP_LABEL, "local_batch": per_rank[0]["local_batch"],
                "eager_losses": eager, "captured_vs_eager_loss_rel": cap_rel,
                "bitwise": bitwise, "launch_calls": calls,
                "launch_calls_rank0": {"eager": per_rank[0]["eager_launch_calls"],
                                       "captured": per_rank[0]["launch_calls"]},
                "peak_gib": [c["peak_gib"] for c in per_rank],
                "eager_peak_gib": [c["eager_peak_gib"] for c in per_rank]}
        if flash:
            per_step = [{n: c["launches"][n] / PP_STEPS for n in KERNELS} for c in per_rank]
            windows = [c["window"] for c in per_rank]
            log(f"pp {model}: launches a step on each rank by the counters {per_step}; a "
                f"profiler window of 2 steps, counters against profiler: {windows}")
            check(all(p == PP_FLASH_PER_STEP for p in per_step),
                  f"pp {model}: K1-K3 launched {per_step} a step, not {PP_FLASH_PER_STEP}")
            check(all(w["counters"] == w["profiler"] for w in windows),
                  f"pp {model}: the profiler's launches are not the counters': {windows}")
            cell.update(launches_per_step=per_step, window=windows)
        cells[model] = cell
    sp = [f["sp"] for f in found]
    first, one = sp[0]["losses"][0], first_losses[SP_CELL[0]]
    sp_rel = abs(first - one) / abs(one)
    curve = next(p["curve"] for p in sp if "curve" in p)
    key = f"{SP_CELL[0]}@sp2tp1"
    log(f"sp (gathered) {SP_CELL[0]} b{SP_CELL[1]} S{SP_CELL[2]} on dp 2 x sp 2: losses "
        f"{sp[0]['losses']} (first vs the one-rank flash trainer's {one:.6f}: rel {sp_rel:.2e}, "
        f"bound {LOSS_RTOL}); step ms {sp[0]['step_ms']} (not an sp speed); curve "
        f"{json.dumps(curve.get(key))}")
    check(sorted(tuple(p["coords"]) for p in sp) == [(0, 0), (0, 1), (1, 0), (1, 1)],
          f"sp coordinates {[p['coords'] for p in sp]}")
    check(all(p["attn"] == "gathered_attention" for p in sp), "the sp core is not the gather")
    check(all(p["losses"] == sp[0]["losses"] for p in sp), "sp: the ranks' losses differ")
    check(all(math.isfinite(x) for x in sp[0]["losses"])
          and sp[0]["losses"][-1] < sp[0]["losses"][0], f"sp: losses {sp[0]['losses']}")
    check(sp_rel < LOSS_RTOL, "sp: the first loss disagrees with the one-rank trainer's")
    check(key in curve and {str(k) for k in SP_KS} <= set(curve[key]["points"]),
          f"sp: the curve has no {key} with points {SP_KS}: {sorted(curve)}")
    return {"card": smi, "mesh": {"pp": 2, "dp": 2, "sp": 1, "tp": 1}, "ranks": MESH_RANKS,
           "transport": "gloo, CUDA tensors staged through host memory", "label": PP_LABEL,
           "kernels": kernels, "cells": cells,
           "sp": {"model": SP_CELL[0], "batch": SP_CELL[1], "seq": SP_CELL[2],
                  "mesh": {"pp": 1, "dp": 2, "sp": 2, "tp": 1}, "losses": sp[0]["losses"],
                  "first_loss_rel": sp_rel, "step_ms": [p["step_ms"] for p in sp],
                  "curve": curve[key], "theta": sp[0]["theta"]}}


def _nccl_checks(torch, port: int) -> dict:
    """Phase 17 in a process of its own (:func:`nccl_worker`): a one-rank
    NCCL group (the card),
    its mesh, and the trainer's multi-rank capture path over it: NCCL_CELL's
    step, captured with the data group's gradient and loss all-reduces in
    the graph, against the same trainer's eager steps from the same init;
    a profiler window of a replay; then what NCCL launches for a one-rank
    sum and average, eagerly and replayed from a captured graph."""
    import torch.distributed as dist

    from gpuschedule_tpu_torch.parallel import ShardedTrainer, make_mesh
    from gpuschedule_tpu_torch.profiler import device_window

    def device_kernels(fn, n=3):
        """{kernel: launches} of ``n`` calls of ``fn`` in one profiler
        window (``device_window``: a window without its marker kernel lost
        its device records and is taken again, each lost one printed)."""
        names = {}
        for rec in device_window(fn, n, what="nccl phase").device:
            names[rec.name[:120]] = names.get(rec.name[:120], 0) + 1
        return names

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        model, batch, seq = NCCL_CELL
        mesh = make_mesh()
        trainer = ShardedTrainer(model, mesh, batch_size=batch, seq_len=seq, flash_attn=True)
        found = {"backend": dist.get_backend(mesh.data_group), "grouped": trainer.grouped,
                 "capturable": trainer.capturable, "nccl": list(torch.cuda.nccl.version())}
        tokens = trainer.make_batch(seed=0)
        state, eager_state = trainer.init(seed=0), trainer.init(seed=0)
        captured, eager = [], []
        for _ in range(NCCL_STEPS):
            state, loss = trainer.step(state, tokens)
            captured.append(loss.item())
        for _ in range(NCCL_STEPS):
            eager_state, loss = trainer._eager_step(eager_state, tokens)
            eager.append(loss.item())
        found.update(captured=captured, eager=eager, graphs=len(trainer._graphs))
        found["replay_kernels"] = device_kernels(lambda: trainer.step(state, tokens), 1)
        x = torch.ones(1 << 20, device="cuda")
        for label, op in (("sum", dist.ReduceOp.SUM), ("avg", dist.ReduceOp.AVG)):
            dist.all_reduce(x, op=op, group=mesh.data_group)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                dist.all_reduce(x, op=op, group=mesh.data_group)
            found[f"{label}_eager"] = device_kernels(
                lambda: dist.all_reduce(x, op=op, group=mesh.data_group))
            found[f"{label}_replay"] = device_kernels(graph.replay)
    finally:
        dist.destroy_process_group()
    return found


def nccl_worker(rank: int, port: int, out_dir: str) -> None:
    """Phase 17's process: a fresh one, whose profiler windows hold what the
    card ran (in this script's process, after the earlier phases' windows,
    the NCCL phase's windows came back without device records)."""
    import torch

    Path(out_dir, "nccl.json").write_text(json.dumps(_nccl_checks(torch, port)))


def nccl_phase(torch, smi) -> dict:
    """Phase 17: the step over a mesh of NCCL groups, captured as one CUDA
    graph (:func:`_nccl_checks`).  One card runs a one-rank group only, so
    this checks the mechanism, not a multi-rank speed: the trainer takes
    its multi-rank capture path, NCCL_STEPS captured steps (4 of them
    replays) within LOSS_RTOL of as many eager steps from the same init,
    and a captured NCCL collective replays its kernel (an average: NCCL
    launches nothing for a one-rank in-place sum, eagerly or replayed,
    which the phase records)."""
    import socket

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with socket.socket() as sock:  # a free port on this machine for the group's store
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(nccl_worker, nprocs=1, start_method="spawn", args=(port, tmp))
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise SmokeFailure(f"the NCCL rank failed: {e}") from None
        found = json.loads(Path(tmp, "nccl.json").read_text())
    rel = max(abs(a - b) / abs(b) for a, b in zip(found["captured"], found["eager"]))
    nccl = [n for n in found["replay_kernels"] if "nccl" in n.lower() or "onerank" in n.lower()]
    log(f"nccl (one rank, NCCL {found['nccl']}): backend {found['backend']}, grouped "
        f"{found['grouped']}, capturable {found['capturable']}, {found['graphs']} graph(s); "
        f"captured losses {found['captured']} vs eager {found['eager']} (max rel {rel:.2e}, "
        f"bound {LOSS_RTOL}); NCCL kernels in a replay of the step: {nccl or 'none'}; a "
        f"one-rank sum launches {found['sum_eager'] or 'nothing'} eagerly and "
        f"{found['sum_replay'] or 'nothing'} replayed; an average "
        f"{found['avg_eager']} eagerly and {found['avg_replay']} replayed")
    check(found["backend"] == "nccl" and found["grouped"] and found["capturable"],
          f"the trainer did not take the multi-rank capture path over NCCL: {found}")
    check(found["graphs"] == 1, "the step over the NCCL group was not captured")
    check(rel < LOSS_RTOL, "the captured step over NCCL disagrees with the eager step")
    avg_nccl = [n for n in found["avg_replay"] if "nccl" in n.lower() or "onerank" in n.lower()]
    check(bool(avg_nccl), f"a captured NCCL average replayed no NCCL kernel: "
                          f"{found['avg_replay']}")
    found.update(card=smi, captured_vs_eager_loss_rel=rel, replay_nccl_kernels=nccl,
                 label="a one-rank NCCL group on one card: the capture mechanism, no "
                       "multi-rank speed", phase_s=time.perf_counter() - t0)
    log(f"phase 17: {found['phase_s']:.1f} s")
    return found


def host_cpu() -> str:
    """The host CPU's model name (the replay is host time): /proc/cpuinfo's,
    else lscpu's, else the machine type."""
    import platform

    name = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key.strip().lower() in ("model name", "cpu model") and value.strip():
                    name = value.strip()
                    break
    except OSError:
        pass
    if name is None and shutil.which("lscpu"):
        res = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30)
        for line in res.stdout.splitlines():
            key, _, value = line.partition(":")
            if key.strip() in ("Model name", "Vendor ID") and value.strip():
                name = value.strip()
                if key.strip() == "Model name":
                    break
    return f"{name or 'model not reported'}, {platform.machine()}, {os.cpu_count()} CPUs"


class Procs:
    """Each of ``cmds`` (label -> command line) in a process of its own,
    all started together from the checkout's root, a waiter thread each;
    :meth:`join` gives each one's exit code, stdout, stderr and wall
    seconds (interpreter start and imports included), timed to its own
    end, None for one that ran past ``timeout`` (it is killed).  Every
    process has ended when :meth:`join` or :meth:`kill` returns."""

    def __init__(self, cmds: dict, timeout: float):
        import threading

        self.labels, self.procs, self.ended = list(cmds), {}, {}

        def wait(label, t0, proc):
            # each process's own end: a thread a process, so one that ends
            # early is not timed to the end of another
            try:
                out, err = proc.communicate(timeout=timeout)
                self.ended[label] = (proc.returncode, out, err, time.perf_counter() - t0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()

        try:
            for label, cmd in cmds.items():
                self.procs[label] = (time.perf_counter(), subprocess.Popen(
                    cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            self.waiters = [threading.Thread(target=wait, args=(label, t0, proc))
                            for label, (t0, proc) in self.procs.items()]
            for t in self.waiters:
                t.start()
        except BaseException:
            self.kill()
            raise

    def kill(self) -> None:
        for _, proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()

    def join(self) -> dict:
        try:
            for t in self.waiters:
                t.join()
        finally:
            self.kill()
        return {label: self.ended.get(label) for label in self.labels}


def cli_procs(cmds: dict, timeout: float = SIM_TIMEOUT_S) -> dict:
    """:class:`Procs` of ``cmds``, waited for: each one's exit code, stdout,
    stderr and wall seconds, None for one that ran past ``timeout``."""
    return Procs(cmds, timeout).join()


def cli_runs(argvs: dict, timeout: float = SIM_TIMEOUT_S) -> dict:
    """``python -m gpuschedule_tpu_torch`` once for each of ``argvs`` (label
    -> the command's arguments), as :func:`cli_procs` starts them: each
    one's stdout line (it must print exactly one and exit 0), that line
    parsed, and its wall seconds."""
    ended = cli_procs({label: [sys.executable, "-m", "gpuschedule_tpu_torch", *argv]
                       for label, argv in argvs.items()}, timeout)
    found = {}
    for label, argv in argvs.items():
        check(ended[label] is not None, f"{argv[0]} ({label}) ran past {timeout} s")
        rc, out, err, wall_s = ended[label]
        lines = out.strip().splitlines()
        for text in err.splitlines():
            print(f"{argv[0]} ({label}): {text}", file=sys.stderr)
        check(rc == 0 and len(lines) == 1,
              f"{argv[0]} ({label}) exited {rc}: {err.strip()[-2000:]}")
        found[label] = {"line": lines[0], "summary": json.loads(lines[0]), "wall_s": wall_s}
    return found


def sim_replays(argvs: dict) -> dict:
    """``run`` once for each of ``argvs`` (label -> arguments), as
    :func:`cli_runs` starts them: each one's summary and wall seconds."""
    found = cli_runs({label: ["run", *argv] for label, argv in argvs.items()})
    return {label: {"summary": rep["summary"], "wall_s": rep["wall_s"]}
            for label, rep in found.items()}


def sim_phase(torch, fa, smi, device=None) -> dict:
    """Phase 20: the simulator's ``run`` path (``gpuschedule_tpu_torch.sim``).
    (i) ``data/philly_10k.csv`` on the default v5p pod under FIFO and DLAS,
    one process each: every job finishes, each replay's wall seconds beside
    the host CPU and the card; (ii) ``run --online`` under Optimus over 1,000
    synthetic jobs on a v5e 16x16 pod, in this process: each model of the
    trace profiled once through ``profile_model`` on the card (the calls
    counted by a wrapper of the harness's function), one curve each in the
    cache, the profiling charge applied once a model, every job finished,
    each curve's k = 1 step (the measured point and the fitted curve)
    within PROFILE_RTOL of a direct ``measure_step_time`` of that model at
    the same batch and length; the profiled steps are dense (as the JAX
    Optimus profiles them), so no flash kernel launches; (iii) the same
    trace offline from the written curves, twice, one process each: equal
    summaries.  ``device="cpu"`` rehearses it off the card."""
    import contextlib
    import io
    from collections import Counter

    from gpuschedule_tpu_torch import cli
    from gpuschedule_tpu_torch.profiler import CurveCache, harness, measure_step_time
    from gpuschedule_tpu_torch.sim.trace import generate_poisson_trace

    t_phase = time.perf_counter()
    cpu = host_cpu()
    # what a replay's wall seconds spend before the replay: a process that
    # only starts and imports the run path
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import gpuschedule_tpu_torch.cli, "
                    "gpuschedule_tpu_torch.sim, gpuschedule_tpu_torch.policies"],
                   cwd=ROOT, check=True, timeout=SIM_TIMEOUT_S)
    import_s = time.perf_counter() - t0
    log(f"phase 20: a process that starts and imports the run path: {import_s:.3f} s")
    found = {"card": smi, "host_cpu": cpu, "import_s": import_s}

    # (i) the 10,000-job Philly replay on v5p-256
    philly = sim_replays({pol: ["--policy", pol, "--cluster", "tpu-v5p", "--philly", SIM_PHILLY]
                          for pol in SIM_REPLAY_POLICIES})
    for pol, rep in philly.items():
        summ = rep["summary"]
        log(f"phase 20 replay: {SIM_PHILLY} on tpu-v5p 8x8x4 under {pol}: "
            f"{rep['wall_s']:.3f} s wall ({len(philly)} replays at once, one process each) on "
            f"host {cpu}; card {smi}; {int(summ['num_finished'])} of "
            f"{int(summ['arrivals'])} jobs finished, avg JCT {summ['avg_jct']:.1f} s")
        check(summ["arrivals"] == 10000 and summ["num_finished"] == summ["arrivals"],
              f"{pol}: not every job of {SIM_PHILLY} finished: {summ}")
    found["philly"] = philly

    # (ii) Optimus online, the profiling on the card
    models = sorted({j.model_name for j in generate_poisson_trace(1000, seed=42)})
    calls: Counter = Counter()
    profile_s = {}
    real = harness.profile_model

    def counted(model, **kw):
        t0 = time.perf_counter()
        curve = real(model, **kw)
        calls[model] += 1
        profile_s[model] = time.perf_counter() - t0
        return curve

    batch, seq = SIM_PROFILE
    launches0 = dict(fa.LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        curves = os.path.join(tmp, "curves.json")
        argv = [*SIM_ONLINE, "--curves", curves]
        on = [] if device is None else ["--device", str(device)]
        harness.profile_model = counted
        out = io.StringIO()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["run", *argv, "--online", *on])
            online_s = time.perf_counter() - t0
        finally:
            harness.profile_model = real
        check(rc == 0, f"run --online exited {rc}")
        online = json.loads(out.getvalue().strip().splitlines()[-1])
        launched = {k: fa.LAUNCHES[k] - launches0.get(k, 0) for k in fa.LAUNCHES}
        cache = CurveCache(curves)
        log(f"phase 20 online: Optimus over {SIM_ONLINE[-3]} synthetic jobs on tpu-v5e 16x16, "
            f"{online_s:.3f} s wall in this process (host {cpu}; card {smi}); profile_model "
            f"calls {dict(calls)}, seconds {json.dumps(profile_s)}; cache {cache.models()}; "
            f"profiling_runs {online.get('profiling_runs')}; flash launches {launched}")
        check(online["arrivals"] == 1000 and online["num_finished"] == online["arrivals"],
              f"run --online: not every job finished: {online}")
        check(sorted(cache.models()) == models, f"the cache holds {cache.models()}, the trace "
                                                f"names {models}")
        check(dict(calls) == {m: 1 for m in models}, f"profile_model calls: {dict(calls)}")
        check(online.get("profiling_runs") == len(models),
              f"the profiling charge was applied {online.get('profiling_runs')} times, "
              f"not once for each of {models}")
        check(not any(launched.values()), f"the profiled (dense) steps launched {launched}")
        fidelity = {}
        with open(curves) as f:
            entries = json.load(f)
        for model in models:
            direct_s = measure_step_time(model, batch_size=batch, seq_len=seq, repeats=3,
                                         device=device)
            point_s = entries[model]["points"]["1"]
            fitted_s = cache.get(model).step_time(1)
            rel = max(abs(point_s - direct_s), abs(fitted_s - direct_s)) / direct_s
            fidelity[model] = {"profile_s": profile_s[model], "k1_point_ms": point_s * 1e3,
                               "k1_fitted_ms": fitted_s * 1e3, "direct_ms": direct_s * 1e3,
                               "rel": rel}
            log(f"phase 20 profile {model} b{batch} S{seq}: {profile_s[model]:.3f} s to profile; "
                f"k=1 point {point_s * 1e3:.4f} ms, fitted {fitted_s * 1e3:.4f} ms, direct "
                f"measure_step_time {direct_s * 1e3:.4f} ms (rel {rel:.3f}, bound "
                f"{PROFILE_RTOL}) on {smi}")
            check(rel <= PROFILE_RTOL, f"{model}: the curve's k=1 step is {rel:.1%} off a direct "
                                       f"measurement")
        # (iii) offline from the written curves, twice: deterministic
        offline = sim_replays({f"offline-{i}": argv for i in (1, 2)})
        check(offline["offline-1"]["summary"] == offline["offline-2"]["summary"],
              "two offline replays from the same curves disagree")
        check(offline["offline-1"]["summary"]["num_finished"] == 1000,
              f"offline: not every job finished: {offline['offline-1']['summary']}")
        for label, rep in offline.items():
            log(f"phase 20 replay: Optimus offline from the curves ({label}): "
                f"{rep['wall_s']:.3f} s wall on host {cpu}; card {smi}")
    found.update(models=models, online={"summary": online, "wall_s": online_s,
                                        "profile_calls": dict(calls), "fidelity": fidelity,
                                        "flash_launches": launched},
                 offline=offline, phase_s=time.perf_counter() - t_phase)
    log(f"phase 20: {found['phase_s']:.1f} s")
    return found


def topology_phase(smi) -> dict:
    """Phase 21: Gandiva and Themis, ``compare-topology``, the shared fabric
    and fault injection, through the port's CLI (``TOPOLOGY_RUNS``, all
    started together, one process each).  Each stdout line must equal the
    JAX package's (``TOPOLOGY_PINS``); every job finishes; the topology
    comparison has its eight replays, the acceptance band and its files;
    the fabric re-prices and changes the summary; the faults fire, and
    the two faulty replays write byte-equal ``jobs.csv``."""
    t_phase = time.perf_counter()
    cpu = host_cpu()
    found = {"card": smi, "host_cpu": cpu, "wall_s": {}}
    with tempfile.TemporaryDirectory() as tmp:
        runs = cli_runs({label: [a.replace("{tmp}", tmp) for a in argv]
                         for label, argv in TOPOLOGY_RUNS.items()}, timeout=TOPOLOGY_TIMEOUT_S)
        for label, rep in runs.items():
            found["wall_s"][label] = rep["wall_s"]
            log(f"phase 21 {label}: python -m gpuschedule_tpu_torch "
                f"{' '.join(TOPOLOGY_RUNS[label])}: {rep['wall_s']:.3f} s wall ({len(runs)} "
                f"commands at once, one process each) on host {cpu}; card {smi}")
        for label, rep in runs.items():
            pin = TOPOLOGY_PINS["faults" if label.startswith("faults") else label]
            check(rep["line"] == pin, f"{label}: the port's line is not the JAX package's:\n"
                                      f"port {rep['line']}\nJAX  {pin}")
        # 1: the Philly trace under Gandiva and Themis
        for label in ("gandiva", "themis", "faults-1"):
            summ = runs[label]["summary"]
            check(summ["arrivals"] == 10000 and summ["num_finished"] == summ["arrivals"],
                  f"{label}: not every job of {SIM_PHILLY} finished: {summ}")
        # 2: the topology comparison
        topo = runs["compare-topology"]["summary"]
        for name in TOPOLOGY_REPLAYS:
            check(topo[name]["num_finished"] == 10000,
                  f"compare-topology {name}: {topo[name]['num_finished']} of 10000 finished")
        check({"jct_delta_pct", "makespan_delta_pct", "within_5pct"} <= set(topo["acceptance"]),
              f"compare-topology: no acceptance band: {topo.get('acceptance')}")
        written = sorted(os.listdir(os.path.join(tmp, "topology")))
        want = sorted(["summary.json", "report.md", *(f"cdf_{n}.csv" for n in TOPOLOGY_REPLAYS)])
        check(written == want, f"compare-topology wrote {written}, not {want}")
        # 3: the shared fabric
        with open(os.path.join(tmp, "net", "counters.json")) as f:
            net_counters = json.load(f)
        check(net_counters.get("net_reprices", 0) > 0, f"--net re-priced nothing: {net_counters}")
        check(runs["net"]["summary"] != runs["no-net"]["summary"],
              "--net left the summary as it is without the fabric")
        # 4: the faults, twice
        with open(os.path.join(tmp, "faults-1", "counters.json")) as f:
            fault_counters = json.load(f)
        for key in ("faults", "fault_revocations", "repairs"):
            check(fault_counters.get(key, 0) > 0, f"--faults: no {key}: {fault_counters}")
        jobs = [Path(tmp, label, "jobs.csv").read_bytes() for label in ("faults-1", "faults-2")]
        check(jobs[0] == jobs[1], "two faulty replays in two processes wrote different jobs.csv")
    acc = topo["acceptance"]
    log(f"phase 21: Gandiva avg JCT {runs['gandiva']['summary']['avg_jct']:.2f} s, Themis "
        f"{runs['themis']['summary']['avg_jct']:.2f} s; acceptance band jct "
        f"{acc['jct_delta_pct']:.2f}%, makespan {acc['makespan_delta_pct']:.2f}%; net_reprices "
        f"{net_counters['net_reprices']}; faults {fault_counters['faults']}, revocations "
        f"{fault_counters['fault_revocations']}, repairs {fault_counters['repairs']}; every "
        f"line the JAX package's")
    found.update(
        pins_equal=True, acceptance=acc, net_reprices=net_counters["net_reprices"],
        faults={k: fault_counters[k] for k in ("faults", "fault_revocations", "repairs",
                                               "migrations")},
        avg_jct={label: runs[label]["summary"]["avg_jct"]
                 for label in ("gandiva", "themis", "net", "no-net", "faults-1")},
        phase_s=time.perf_counter() - t_phase)
    log(f"phase 21: {found['phase_s']:.1f} s")
    return found


def events_phase(smi) -> dict:
    """Phase 22: the event stream and resume, through the port's CLI on
    ``data/philly_10k.csv`` on the default v5p pod.  Four replays at once,
    one process each (``EVENTS_REPLAYS``): DLAS with ``--events --attrib
    --perfetto --self-profile --history``, FIFO with ``--events
    --history`` into a store of its own, DLAS under ``--accounting v2``, and DLAS with periodic
    ``--snapshot``s.  Then, at once: the last snapshot resumed in a fresh
    process (``EVENTS_RESUME``) onto a copy of the snapshotted run's stream
    with a crashed run's garbage tail, and the stream's readers
    (``EVENTS_READERS``: ``report`` in memory, ``--low-mem`` and
    ``--selfprof``, ``compare``, ``obs export``); then ``history trend``
    and ``list`` of each store.  Each line, exit code and file must be the JAX
    package's (``EVENTS_*`` pins; the self-profile by its phases and
    batches), the resumed run's files the uninterrupted run's bytes, and
    no process may make a CUDA context (``CLI_NO_CUDA``)."""
    import hashlib

    t_phase = time.perf_counter()
    cpu = host_cpu()
    found = {"card": smi, "host_cpu": cpu, "wall_s": {}}
    with tempfile.TemporaryDirectory() as tmp:
        def run_stage(cmds):
            argvs = {label: [a.replace("{tmp}", tmp) for a in argv]
                     for label, argv in cmds.items()}
            ended = cli_procs({label: [sys.executable, "-c", CLI_NO_CUDA, *argv]
                               for label, argv in argvs.items()}, EVENTS_TIMEOUT_S)
            res = {}
            for label, argv in cmds.items():
                check(ended[label] is not None, f"{argv[0]} ({label}) ran past "
                                                f"{EVENTS_TIMEOUT_S} s")
                rc, out, err, wall_s = ended[label]
                err_lines = err.strip().splitlines()
                check(bool(err_lines) and err_lines[-1] == "cuda_initialized=False",
                      f"{argv[0]} ({label}) exited {rc} or made a CUDA context: "
                      f"{err.strip()[-2000:]}")
                found["wall_s"][label] = wall_s
                log(f"phase 22 {label}: python -m gpuschedule_tpu_torch {' '.join(argv)}: "
                    f"{wall_s:.3f} s wall ({len(cmds)} commands at once, one process each) "
                    f"on host {cpu}; card {smi}")
                res[label] = {"rc": rc, "out": out.strip(), "err": err_lines[:-1]}
            return res

        def sha(name):
            return hashlib.sha256(Path(tmp, name).read_bytes()).hexdigest()

        # 1-4: the replays
        replays = run_stage(EVENTS_REPLAYS)
        for label, rep in replays.items():
            check(rep["rc"] == 0 and rep["out"] == EVENTS_PINS[label],
                  f"{label}: exit {rep['rc']}; the port's line is not the JAX package's:\n"
                  f"port {rep['out']}\nJAX  {EVENTS_PINS[label]}")
        for name in ("dlas/events.jsonl", "fifo/events.jsonl", "snap/events.jsonl",
                     "dlas.trace.json"):
            check(sha(name) == EVENTS_SHA256[name], f"{name} is not the JAX package's file")
        with open(os.path.join(tmp, "dlas", "events.jsonl")) as f:
            check(f.readline().strip() == EVENTS_HEADER, "the DLAS stream's header is not "
                                                         "the JAX package's")
        with open(os.path.join(tmp, "dlas.prof.json")) as f:
            prof = json.load(f)["selfprof"]
        check(prof["batches"] == EVENTS_PROFILE["batches"]
              and tuple(prof["phases"]) == EVENTS_PROFILE["phases"],
              f"the self-profile has {prof['batches']} batches and phases "
              f"{list(prof['phases'])}, not the JAX run's {EVENTS_PROFILE}")
        phase_sum = sum(v["total_s"] for v in prof["phases"].values())
        check(abs(phase_sum - prof["total_wall_s"]) <= 1e-9 * prof["total_wall_s"],
              f"the profile's phases sum to {phase_sum}, not {prof['total_wall_s']}")
        with open(os.path.join(tmp, "s.pkl.meta.json")) as f:
            snapshots = json.load(f)["snapshot_writes"]
        check(snapshots >= 3, f"{snapshots} snapshots over the replay, fewer than 3")

        # 5: the resume, and the stream's readers
        os.makedirs(os.path.join(tmp, "resumed"))
        shutil.copy(os.path.join(tmp, "snap", "events.jsonl"),
                    os.path.join(tmp, "resumed", "events.jsonl"))
        with open(os.path.join(tmp, "resumed", "events.jsonl"), "a") as f:
            f.write('{"event": "garbage-from-crashed-tail')
        readers = run_stage({"resume": EVENTS_RESUME, **EVENTS_READERS})
        check(readers["resume"]["rc"] == 0 and readers["resume"]["out"] == EVENTS_PINS["snap"],
              f"the resumed run: exit {readers['resume']['rc']}, line "
              f"{readers['resume']['out']}")
        for name in ("events.jsonl", "jobs.csv", "utilization.csv", "counters.json"):
            check(sha(f"resumed/{name}") == sha(f"snap/{name}"),
                  f"the resumed run's {name} is not the uninterrupted run's")
        for label in ("report", "report-low-mem", "report-selfprof"):
            rep = readers[label]
            check(rep["rc"] == 0, f"{label} exited {rep['rc']}: {rep['err'][-5:]}")
            line = json.loads(rep["out"])
            line.pop("report")
            check(line == EVENTS_REPORT, f"{label}: {line}, not {EVENTS_REPORT}")
        check(sha("report.html") == sha("report_lm.html") == EVENTS_SHA256["report.html"],
              "the report's HTML in memory and --low-mem are not both the JAX package's")
        for name in ("report.json", "report_lm.json", "compare.json"):
            check(sha(name) == EVENTS_SHA256[name], f"{name} is not the JAX package's file")
        html = Path(tmp, "report_sp.html").read_text()
        check("Engine health" in html and "event_apply" in html,
              "report --selfprof has no Engine-health phase panel")
        check(readers["compare"]["rc"] == EVENTS_COMPARE_RC,
              f"compare exited {readers['compare']['rc']}, the JAX package "
              f"{EVENTS_COMPARE_RC}")
        check(readers["export"]["rc"] == 0 and sha("export.json") == sha("dlas.trace.json"),
              "obs export of the DLAS stream is not run --perfetto's file")

        # the history the runs and the compare appended: DLAS's run, then
        # the compare's two rows; FIFO's run in its own store
        history = run_stage(EVENTS_HISTORY)
        check(history["trend"]["rc"] == 0 and history["trend"]["out"] == EVENTS_TREND,
              f"history trend:\n{history['trend']['out']}\nnot the JAX package's\n"
              f"{EVENTS_TREND}")
        for label, pin in (("list", EVENTS_LIST), ("list-fifo", EVENTS_LIST_FIFO)):
            check(history[label]["rc"] == 0 and history[label]["out"] == pin,
                  f"history {label}:\n{history[label]['out']}\nnot the JAX package's")
    found.update(pins_equal=True, snapshots=snapshots, profile_batches=prof["batches"],
                 profile_total_wall_s=prof["total_wall_s"],
                 profile_shares={k: v["share"] for k, v in prof["phases"].items()},
                 compare_rc=readers["compare"]["rc"], cuda_initialized=False,
                 phase_s=time.perf_counter() - t_phase)
    log(f"phase 22: every line and file the JAX package's; the resumed run's files the "
        f"uninterrupted run's ({snapshots} snapshots); no process made a CUDA context; "
        f"{found['phase_s']:.1f} s")
    return found


def _sha(text: str) -> str:
    import hashlib

    return hashlib.sha256(text.encode()).hexdigest()


def whatif_canonical_sha(path) -> str:
    """sha256 of a ``whatif --out`` document without its wall-clock
    readings (``canonical_document``) and without ``pool``, the pool size
    it was asked for: a pooled document is held to the serial one."""
    from gpuschedule_tpu_torch.sim.whatif import canonical_document

    with open(path) as f:
        doc = canonical_document(json.load(f))
    doc.pop("pool")
    return _sha(json.dumps(doc, sort_keys=True))


def whatif_history(store) -> tuple:
    """A ``whatif --history`` store's query rows without their time stamp
    and latency, as sha256 of their JSON, and the pool row's metrics (None
    without a pool)."""
    from gpuschedule_tpu_torch.obs import HistoryStore

    with HistoryStore(store) as st:
        rows = st.rows(kind="whatif")
    kept = [{"seq": r.seq, "kind": r.kind, "run_id": r.run_id, "config_hash": r.config_hash,
             "policy": r.policy, "seed": r.seed, "label": r.label,
             "metrics": {k: v for k, v in r.metrics.items() if k != "latency_ms"}}
            for r in rows if r.label != "pool"]
    pool = [r.metrics for r in rows if r.label == "pool"]
    return _sha(json.dumps(kept, sort_keys=True)), (pool[0] if pool else None)


def prom_families(text: str) -> tuple:
    """A ``--prom`` file as sha256 of its lines without the latency
    histogram's buckets and sum (wall clock) and the pool's counters
    (there only when pooled), and the pool counters' lines."""
    lines = text.strip().splitlines()
    kept = [ln for ln in lines if not ln.startswith(("whatif_query_latency_ms_bucket",
                                                     "whatif_query_latency_ms_sum"))
            and "pool_" not in ln]
    return _sha("\n".join(kept)), [ln for ln in lines if ln.startswith("pool_")]


def fleet_shape(doc: dict) -> dict:
    """The time-free structure of a merged fleet trace: its federation,
    its exporter and trace id, the merged registry's counters, the
    parent's spans (name and args) and every worker span's name and args
    counted over all workers (which worker ran a task is the pool's
    choice)."""
    procs = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    parent, workers = [], {}
    for e in doc["traceEvents"]:
        if e["ph"] != "X":
            continue
        item = json.dumps([e["name"], e.get("cat"), e.get("args", {})], sort_keys=True)
        if procs[e["pid"]] in doc["federation"]["workers"]:
            workers[item] = workers.get(item, 0) + 1
        else:
            parent.append(item)
    counters = {name: fam["value"] for name, fam in doc.get("registry", {}).items()
                if fam["kind"] == "counter"}
    return {"federation": doc["federation"], "other": doc["otherData"], "counters": counters,
            "parent": sorted(parent), "workers": dict(sorted(workers.items())),
            "selfprof_workers": sorted(doc.get("selfprof", {}).get("workers", {}))}


def check_fleet(path, *, trace_id, tasks, pool, parent, worker_spans, counters) -> dict:
    """Phase 23's structure check of a merged fleet trace: ``tasks`` tasks
    over workers of a pool of ``pool``, the parent's span names, each
    task's worker spans (``worker_spans`` a task) all carrying the trace id
    and the dispatch span as their parent, the named counters."""
    with open(path) as f:
        doc = json.load(f)
    shape = fleet_shape(doc)
    fed = shape["federation"]
    names = {f"worker-{i}" for i in range(pool)}
    check(fed["tasks"] == tasks and fed["workers"] and set(fed["workers"]) <= names,
          f"{path}: federation {fed}, not {tasks} tasks over workers of {sorted(names)}")
    check(shape["other"]["trace_id"] == trace_id and shape["other"]["clock"] == "wall",
          f"{path}: otherData {shape['other']}")
    got = sorted({json.loads(item)[0] for item in shape["parent"]})
    check(got == sorted(parent), f"{path}: parent spans {got}, not {sorted(parent)}")
    per_name = {}
    for item, n in shape["workers"].items():
        name, _, args = json.loads(item)
        check(args.get("trace_id") == trace_id and args.get("parent_span_id") == "dispatch"
              and 0 <= args.get("task", -1) < tasks,
              f"{path}: a worker span {name} does not link to the dispatch: {args}")
        per_name[name] = per_name.get(name, 0) + n
    for name, each in worker_spans.items():
        check(per_name.get(name) == each * tasks,
              f"{path}: {per_name.get(name)} worker spans {name}, not {each} a task")
    for name, value in counters.items():
        check(shape["counters"].get(name) == value,
              f"{path}: counter {name} {shape['counters'].get(name)}, not {value}")
    return {"tasks": fed["tasks"], "workers": fed["workers"],
            "worker_spans": dict(sorted(per_name.items())),
            "selfprof_workers": shape["selfprof_workers"]}


def sweep_cmd(entry, tmp) -> list:
    """The command line of a phase-23 entry: through SWEEP_NO_CUDA."""
    kind, *argv = entry
    return [sys.executable, "-c", SWEEP_NO_CUDA, kind, *(a.replace("{tmp}", tmp) for a in argv)]


def sweeps_start(tmp) -> "Procs":
    """Phase 23's processes that run beside phase 21's (SWEEP_RUNS and
    WHATIF_CUDA), started now; :func:`sweeps_check` reads them."""
    cmds = {label: sweep_cmd(entry, tmp) for label, entry in SWEEP_RUNS.items()}
    cmds["whatif-cuda"] = sweep_cmd(WHATIF_CUDA, tmp)
    return Procs(cmds, SWEEP_TIMEOUT_S)


def _sweep_ended(ended, label, found, cpu, smi, cuda=False,
                 how="started with phase 21's commands, one process each") -> dict:
    check(ended[label] is not None, f"phase 23 {label} ran past {SWEEP_TIMEOUT_S} s")
    rc, out, err, wall_s = ended[label]
    err_lines = err.strip().splitlines()
    check(rc == 0 and bool(err_lines) and err_lines[-1] == f"cuda_initialized={cuda}",
          f"phase 23 {label} exited {rc}, or its CUDA context is not {cuda}: "
          f"{err.strip()[-2000:]}")
    found["wall_s"][label] = wall_s
    log(f"phase 23 {label}: {wall_s:.3f} s wall ({how}) on host {cpu}; card {smi}")
    return {"out": out.strip(), "err": err_lines[:-1]}


def sweeps_check(procs, tmp, smi) -> dict:
    """Phase 23, the part beside phase 21: wait for :func:`sweeps_start`'s
    processes and hold what they printed and wrote to the JAX package's
    (SWEEP_PINS, SWEEP_LINES), the fleet traces to their structure, and
    the whatif spawned on the card to its curve file."""
    cpu = host_cpu()
    found = {"card": smi, "host_cpu": cpu, "wall_s": {}}
    ended = procs.join()
    res = {label: _sweep_ended(ended, label, found, cpu, smi) for label in SWEEP_RUNS}
    cuda = _sweep_ended(ended, "whatif-cuda", found, cpu, smi, cuda=True)

    def read(name):
        return Path(tmp, name).read_text().replace(tmp, "{tmp}")

    def pinned(label, got):
        check(got == SWEEP_PINS[label], f"{label}: not the JAX package's ({got})")

    # 1: faults at its defaults
    pinned("faults line", _sha(res["faults"]["out"].replace(tmp, "{tmp}")))
    pinned("faults.json", _sha(read("faults.json")))
    streams = sorted(os.listdir(os.path.join(tmp, "fev")))
    check(streams == sorted(k for k in SWEEP_PINS if k.endswith(".events.jsonl")),
          f"faults --events wrote {streams}")
    for name in streams:
        pinned(name, _sha(read(f"fev/{name}")))
    # 2, 3: the sweeps, pooled, against the serial artifacts; their fleets
    for label, trace_id in (("fault_sweep", "fault-sweep-s0"), ("net_sweep", "net-sweep-s0")):
        short = "fs" if label == "fault_sweep" else "ns"
        pinned(f"{short}.json", _sha(read(f"{short}.json")))
        line = json.loads(res[label]["out"])
        found[label] = check_fleet(
            os.path.join(tmp, f"{short}.trace.json"), trace_id=trace_id, tasks=line["cells"],
            pool=4, parent=("dispatch",), worker_spans={"task": 1, "build": 1, "replay": 1},
            counters={"pool_worker_respawns_total": 0.0, "pool_task_retries_total": 0.0})
        found[label]["cells"] = line["cells"]
    # 4: whatif on the Philly trace, pooled
    doc = json.loads(Path(tmp, "wi.json").read_text())
    pinned("whatif canonical", whatif_canonical_sha(os.path.join(tmp, "wi.json")))
    rows_sha, pool_row = whatif_history(os.path.join(tmp, "wi.db"))
    pinned("whatif history", rows_sha)
    n_queries = len(doc["queries"])
    check(pool_row == {"workers": WHATIF_POOL, "respawns": 0, "retries": 0,
                       "queries": n_queries}, f"whatif's history pool row: {pool_row}")
    prom_sha, pool_lines = prom_families(read("wi.prom"))
    pinned("whatif prom", prom_sha)
    check(pool_lines == ["pool_task_retries_total 0", "pool_worker_respawns_total 0"],
          f"whatif --prom pool counters: {pool_lines}")
    found["whatif"] = check_fleet(
        os.path.join(tmp, "wi.trace.json"), trace_id=doc["run_id"], tasks=n_queries,
        pool=WHATIF_POOL, parent=("enqueue", "dispatch", "reassemble"),
        worker_spans={"task": 1, "fork": 1, "restore": 1, "mutate": 1, "replay": 1, "diff": 1},
        counters={"whatif_queries_total": {'{kind="admit"}': 16.0, '{kind="drain"}': 1.0,
                                           '{kind="policy-swap"}': 1.0}})
    found["whatif"].update(latency_ms=doc["latency_ms"], at_s=doc["at_s"],
                           mirror=doc["mirror"])
    # 5: whatif from a snapshot
    pinned("whatif-resume canonical", whatif_canonical_sha(os.path.join(tmp, "wr.json")))
    # 6: the smokes and the chaos sweep
    for label, want in SWEEP_LINES.items():
        line = json.loads(res[label]["out"].splitlines()[-1])
        line.pop("tmp", None)
        check(line == want, f"{label}: {line}, not the JAX package's {want}")
    # the pool on the card: spawned workers, the unseen model profiled by one
    with open(os.path.join(tmp, "wc.json")) as f:
        curves = json.load(f)
    model = curves.get(WHATIF_CUDA_MODEL, {})
    check(model.get("source", "").startswith("measured"),
          f"whatif-cuda: no measured curve of {WHATIF_CUDA_MODEL} in the curve file: "
          f"{sorted(curves)}")
    wc = json.loads(Path(tmp, "wc.out.json").read_text())
    admitted = wc["queries"][0].get("admitted", {})
    check(admitted.get("end_state") is not None, f"whatif-cuda: the admit has no outcome: {wc}")
    with open(os.path.join(tmp, "wc.trace.json")) as f:
        wc_workers = json.load(f)["federation"]["workers"]
    found["whatif_cuda"] = {"models": sorted(curves), "profiled_by_worker": WHATIF_CUDA_MODEL,
                            "workers": wc_workers, "admitted": admitted}
    log(f"phase 23 (beside phase 21): every pin the JAX package's; the fleet traces whole; "
        f"whatif on the card spawned its pool and a worker profiled {WHATIF_CUDA_MODEL}")
    return found


def sweeps_timed(found, tmp, smi) -> dict:
    """Phase 23, after phase 22, alone on the host: ``tools.engine_bench``
    at 10,000 jobs with its gate (the port's floors file), then
    ``tools.whatif_bench`` at its defaults with its gate."""
    cpu = found["host_cpu"]
    for label, entry in SWEEP_TIMED.items():
        ended = Procs({label: sweep_cmd(entry, tmp)}, SWEEP_TIMEOUT_S).join()
        rep = _sweep_ended(ended, label, found, cpu, smi, how="alone on the host")
        found[label] = json.loads(rep["out"].splitlines()[-1])
        check(found[label]["ok"], f"{label}'s gate failed: {found[label]}")
    with open(os.path.join(tmp, "eb.json")) as f:
        ladder = json.load(f)["ladder"]
    found["engine_bench"]["rungs"] = {
        r["config"]: {k: r.get(k) for k in ("elapsed_s", "jobs_per_s", "events_per_s",
                                            "rss_peak_mb")} for r in ladder}
    log(f"phase 23: engine_bench jobs/s {found['engine_bench']['jobs_per_s']}; whatif_bench "
        f"{found['whatif_bench']} on host {cpu}; card {smi}")
    return found


def entry_phase(torch) -> dict:
    """Phase 18: ``entry()`` on the card, its logits held to the one-rank
    model's from the same seed on the same tokens (within FWD_TOL)."""
    from gpuschedule_tpu_torch.entry import FLAGSHIP, entry
    from gpuschedule_tpu_torch.parallel import ShardedTrainer

    fn, args = entry()
    logits = fn(*args)
    trainer = ShardedTrainer(FLAGSHIP, batch_size=4, seq_len=128)
    state = trainer.init(seed=0)
    with torch.no_grad():
        ref = state.model(args[1])
    err = (logits - ref).abs().max().item()
    log(f"entry(): {FLAGSHIP} logits {tuple(logits.shape)} {logits.dtype} on {logits.device}, "
        f"max abs error against the one-rank model's {err:.3e} (bound {FWD_TOL})")
    check(logits.is_cuda and tuple(logits.shape) == (4, 128, trainer.cfg.vocab)
          and bool(torch.isfinite(logits).all()), "entry()'s logits")
    check(err < FWD_TOL, "entry()'s logits disagree with the one-rank model's")
    out = {"model": FLAGSHIP, "shape": list(logits.shape), "max_abs_err": err}
    del fn, args, logits, ref, state, trainer
    torch.cuda.empty_cache()
    return out


def _tools_checks(torch) -> dict:
    """Phase 19's tools, in a process of its own (:func:`tools_worker`):
    ``roofline.analyze`` at MAIN_SHAPE, LONGCTX_SHAPE and TOOLS_SHAPE:
    executed FLOPs at least the function's, the function's
    bounds SECTION6_BOUNDS; K1-K3 at TOOLS_SHAPE against their plain
    versions within phase 3's bounds and timed (:func:`kernels_at`);
    ``kernel_bench.run`` at its two shapes: every row's ms positive, the
    flash rows' launches K1 (fwd) or K1-K3 (fwd+bwd) once a call;
    ``trace_flash``: the flash case's top device operations name K1-K3,
    and each case's device ms within TRACE_RTOL of kernel_bench's;
    ``roofline.fit_overhead`` of the measured flash fwd+bwd.  First, which
    records the windows of ``tools.window_probe`` hold in this process; the
    windows the tools took and lost are printed."""
    import torch.nn.functional as F

    from gpuschedule_tpu_torch.cluster.cards import CARDS, detect_card, nvidia_smi_line
    from gpuschedule_tpu_torch.profiler import time_callable
    from gpuschedule_tpu_torch.profiler.harness import TALLY
    from gpuschedule_tpu_torch.tools import kernel_bench, roofline, trace_flash, window_probe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa = importlib.import_module("gpuschedule_tpu_torch.ops.flash_attention")
    smi, dev = nvidia_smi_line(), torch.device("cuda")
    peaks = CARDS[detect_card(torch.cuda.get_device_name(0))]
    ms = lambda fn, iters=20: time_callable(fn, iters=iters, warmup=3, device=dev) * 1e3  # noqa: E731
    probe = window_probe.Probe().series("phase 19's own process", PROBE_WINDOWS, PROBE_FORMS)
    log(f"phase 19: windows of the window probe in its own process holding each kind of "
        f"record: {json.dumps(probe)}")
    before = dict(TALLY)
    analyses = {}
    for shape in (MAIN_SHAPE, LONGCTX_SHAPE, TOOLS_SHAPE):
        a = analyses[shape] = roofline.analyze(*shape)
        fn_bounds = tuple(a["function"][k]["bound_ms"] for k in roofline.KERNELS)
        log(f"roofline {shape}: executed {sum(a['executed_gflops'].values()):.1f} GFLOP, "
            f"{a['executed_over_function_flops']:.4f}x the function's; executed roofline "
            f"fwd+bwd {a['roofline_fwdbwd_ms']:.4f} ms, the function's bounds "
            f"{[round(x, 4) for x in fn_bounds]} ms; tile traffic over HBM bytes "
            f"{ {k: round(b['tile_traffic_over_hbm'], 1) for k, b in a['bounds_ms'].items()} }")
        check(a["executed_over_function_flops"] >= 1,
              f"roofline {shape}: executed FLOPs below the function's")
        if shape in SECTION6_BOUNDS:
            check(tuple(round(x, 4) for x in fn_bounds) == SECTION6_BOUNDS[shape],
                  f"roofline {shape}: bounds {fn_bounds} are not PERF.md's "
                  f"{SECTION6_BOUNDS[shape]}")
    kernels = kernels_at(torch, fa, dev, TOOLS_SHAPE, ms, peaks, F, 1900, "the tools' D = 128")
    rows = []
    for shape in kernel_bench.SHAPES:
        rows += kernel_bench.run(*shape, torch.bfloat16, dev)
    check(all(r["ms"] > 0 for r in rows), "kernel_bench: a row has no time")
    fwd_bwd = {"flash_fwd": 1.0, "flash_bwd_dq": 1.0, "flash_bwd_dkdv": 1.0}
    for r in rows:
        if " flash " in r["case"]:
            want = fwd_bwd if "fwd+bwd" in r["case"] else {**dict.fromkeys(fwd_bwd, 0.0),
                                                           "flash_fwd": 1.0}
            check(r["route"] == "cuda" and r["launches"] == want,
                  f"kernel_bench {r['case']}: launches {r['launches']}, not {want}")
    traced = trace_flash.main([])
    by_case = {r["case"].split(" ", 2)[2]: r for r in rows if r["case"].startswith("b2s4096h8d128")}
    for rec in traced:
        top = rec["top_device_ops_ms_per_iter"]
        bench_ms = by_case[rec["case"]]["device_ms"]
        gap = rec["device_ms_per_iter"] / bench_ms - 1
        log(f"trace_flash {rec['case']}: {rec['device_ms_per_iter']:.4f} device ms an iteration "
            f"vs kernel_bench's {bench_ms:.4f} ({gap:+.2%}, bound {TRACE_RTOL:.0%}); top "
            f"{json.dumps(top)}")
        check(abs(gap) <= TRACE_RTOL, f"trace_flash {rec['case']}: device ms off kernel_bench's")
        if rec["case"].startswith("flash"):
            check(all(any(k in op for op in top) for k in TENSOR_CORE_KERNELS),
                  f"trace_flash {rec['case']}: the top device operations do not name K1-K3")
    flash = by_case[trace_flash.TRACED[1]]
    fit = roofline.fit_overhead(flash["device_ms"], analyses[TOOLS_SHAPE])
    log(f"fit_overhead {TOOLS_SHAPE} flash fwd+bwd: {json.dumps(fit)}")
    windows = {k: TALLY[k] - before[k] for k in TALLY}
    log(f"phase 19: the tools took {windows['taken']} profiler windows and lost "
        f"{windows['lost']}")
    return {"card": smi, "roofline": {str(k): a for k, a in analyses.items()},
            "kernels": kernels, "kernel_bench": rows, "trace_flash": traced, "fit": fit,
            "windows": windows, "window_probe": probe}


def tools_worker(rank: int, out_dir: str) -> None:
    """Phase 19's process: a fresh one.  This script's own process has by
    then shared the card with phases 10-17's processes, and its profiler
    windows drop device records (ROADMAP Queue 3)."""
    import torch

    Path(out_dir, "tools.json").write_text(json.dumps(_tools_checks(torch)))


def tools_phase(torch, smi) -> dict:
    """Phase 19: the port's tools.  In the script's own process, after
    phases 1-18, which records PROBE_WINDOWS windows of each of
    PROBE_FORMS of ``tools.window_probe`` hold, and the windows the process
    took and lost so far; then :func:`_tools_checks` in a process of its
    own; the phase's seconds."""
    import torch.multiprocessing as mp

    from gpuschedule_tpu_torch.profiler.harness import TALLY
    from gpuschedule_tpu_torch.tools import window_probe

    t0 = time.perf_counter()
    probe = window_probe.Probe().series("the script's process after phases 1-18",
                                        PROBE_WINDOWS, PROBE_FORMS)
    log(f"phase 19: this process has taken {TALLY['taken']} profiler windows and lost "
        f"{TALLY['lost']}; windows of the window probe in it holding each kind of record: "
        f"{json.dumps(probe)}")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(tools_worker, nprocs=1, start_method="spawn", args=(tmp,))
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise SmokeFailure(f"the tools' process failed: {e}") from None
        found = json.loads(Path(tmp, "tools.json").read_text())
    found.update(card=smi, window_probe_script_process=probe, windows_script_process=dict(TALLY),
                 phase_s=time.perf_counter() - t0)
    log(f"phase 19: {found['phase_s']:.1f} s")
    return found


def run() -> dict:
    # each phase's wall seconds, in the order the phases run (the
    # ``{"train": ...}`` line's ``phase_wall_s``)
    walls, t_lap = {}, [time.perf_counter()]

    def lap(label):
        now = time.perf_counter()
        walls[label] = now - t_lap[0]
        t_lap[0] = now

    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no card to drive")
    try:
        import torch.nn.functional as F

        from gpuschedule_tpu_torch.cluster.cards import CARDS, detect_card, nvidia_smi_line
        from gpuschedule_tpu_torch.ops import _build, dense_attention
        from gpuschedule_tpu_torch.ops import overhead_probe as op
        from gpuschedule_tpu_torch.parallel import ShardedTrainer
        from gpuschedule_tpu_torch.parallel.train import make_optimizer
        from gpuschedule_tpu_torch.profiler import device_ms_per_launch, time_callable, time_steps
        from gpuschedule_tpu_torch.tools.roofline import attention_cost, bound

        # the module, not the op of the same name that ops/__init__ exports
        fa = importlib.import_module("gpuschedule_tpu_torch.ops.flash_attention")
    except ImportError as e:
        raise SmokeFailure(f"cannot import the port: {e}") from None

    # the plain versions' f32 products are the reference: keep them f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- 1 --
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    props = torch.cuda.get_device_properties(0)
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
        f"{props.multi_processor_count} SMs, {props.total_memory / 2**30:.2f} GiB, "
        f"compute capability {props.major}.{props.minor}")
    log(smi)
    card = detect_card(kind)
    check(card is not None, f"no published peaks for {kind!r} in CARDS: no bound to hold times to")
    peaks = CARDS[card]
    dev = torch.device("cuda")

    lap("1")
    # ---------------------------------------------------------------- 2 --
    t0 = time.perf_counter()
    fa._kernels()  # builds every csrc/*.cu, one nvcc each, in parallel
    op._kernels()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s")
    for stem in ("flash_attention", "overhead_probe"):
        for line in _build.build_log(stem).splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas: {line.strip()}", file=sys.stderr)
    ptxas = ptxas_report(_build.build_log("flash_attention"))
    hmma = None
    tool = cuobjdump_path()
    if tool is None:
        log("cuobjdump: not found beside nvcc, on PATH or in Triton; no SASS check")
    else:
        hmma = hmma_counts(str(_build.build_all()["flash_attention"]), tool)
    build_report = {}
    # (kernel, its mangled output type, report label): the FMA kernels, then
    # the tensor-core kernels in both output forms
    variants = [(f32_name, "", "") for _, f32_name, _ in KERNELS.values()]
    variants += [(cname, MANGLED_OUT[out], "" if out == "bf16" else ", f32 out")
                 for cname in TENSOR_CORE_KERNELS for out in ("bf16", "f32")]
    for cname, tail, label in variants:
        for d in fa.HEAD_DIMS:
            entry = ptxas.get(mangled_name(ptxas, cname, d, tail), {})
            n_hmma = None if hmma is None else hmma.get(mangled_name(hmma, cname, d, tail))
            build_report[f"{cname}<{d}{label}>"] = {**entry, "hmma": n_hmma}
            log(f"kernel {cname} D={d}{label}: {entry.get('registers')} registers, spill "
                f"{entry.get('spill_stores')}/{entry.get('spill_loads')} bytes "
                f"(stores/loads), {n_hmma} HMMA")
    for cname, _, label in variants[len(KERNELS):]:
        for d in fa.HEAD_DIMS:
            rep = build_report[f"{cname}<{d}{label}>"]
            check("registers" in rep, f"ptxas reported nothing for {cname} at D={d}{label}")
            if d in NO_SPILL_HEAD_DIMS:
                check(rep.get("spill_stores", 0) == 0 and rep.get("spill_loads", 0) == 0,
                      f"{cname} spills at D={d}{label}: {rep}")
            if hmma is not None:
                check((rep["hmma"] or 0) > 0,
                      f"{cname} at D={d}{label} has no HMMA in its SASS")
    probe_ptxas = ptxas_report(_build.build_log("overhead_probe"))
    probe_hmma = None if tool is None else hmma_counts(
        str(_build.build_all()["overhead_probe"]), tool)
    lib = op._kernels()
    stages = lib.gst_probe_stages()  # the depth of the kernels' ring
    for name, (cname, _) in PROBE_KERNELS.items():
        entry = probe_ptxas.get(mangled_name(probe_ptxas, cname, PROBE_BLOCK), {})
        n_hmma = None if probe_hmma is None else probe_hmma.get(
            mangled_name(probe_hmma, cname, PROBE_BLOCK))
        smem = {form: lib.gst_probe_smem(int(name == "probe_matmul"), PROBE_N, parallel)
                for form, parallel in (("parallel", 1), ("sequential", 0))}
        build_report[f"{cname}<{PROBE_BLOCK}>"] = {**entry, "hmma": n_hmma, "dynamic_smem": smem}
        log(f"kernel {cname} BLOCK={PROBE_BLOCK}: {entry.get('registers')} registers, spill "
            f"{entry.get('spill_stores')}/{entry.get('spill_loads')} bytes (stores/loads), "
            f"{entry.get('static_smem', 0)} bytes static smem, dynamic smem {smem['parallel']} B "
            f"a block in the parallel form and {smem['sequential']} B in the sequential one "
            f"(STAGES = {stages}), {n_hmma} HMMA")
        check("registers" in entry, f"ptxas reported nothing for {cname}")
        check(entry.get("spill_stores", 0) == 0 and entry.get("spill_loads", 0) == 0,
              f"{cname} spills: {entry}")
    if probe_hmma is not None:
        check((build_report[f"probe_xtx_kernel<{PROBE_BLOCK}>"]["hmma"] or 0) > 0,
              "probe_xtx_kernel has no HMMA in its SASS")

    lap("2")
    # ---------------------------------------------------------------- 3 --
    errs = {name: 0.0 for name in KERNELS}
    parity = [  # bf16: the tensor-core kernels; f32: the FMA kernels
        (MAIN_SHAPE, torch.bfloat16, True),
        ((2, 1000, 4, 64), torch.bfloat16, True),
        ((2, 1000, 4, 64), torch.bfloat16, False),
        ((1, 333, 2, 96), torch.bfloat16, True),
        ((1, 200, 3, 128), torch.bfloat16, False),
        ((1, 200, 3, 128), torch.bfloat16, True),
        ((1, 77, 2, 32), torch.bfloat16, True),
        ((1, 77, 2, 32), torch.bfloat16, False),
        ((2, 1000, 4, 64), torch.float32, True),
        ((2, 1000, 4, 64), torch.float32, False),
        ((1, 200, 3, 128), torch.float32, False),
        ((1, 77, 2, 32), torch.float32, True),
    ]
    for i, (shape, dtype, causal) in enumerate(parity):
        for name, e in kernel_parity(torch, fa, dev, shape, dtype, causal, 100 + i)["abs"].items():
            errs[name] = max(errs[name], e)

    # the whole op (autograd through the three kernels) against the dense oracle
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(7)
        q, k, v = (torch.randn((2, 1000, 4, 64), generator=gen, device=dev).to(dtype)
                   .requires_grad_(True) for _ in range(3))
        out = fa.flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
        ref = dense_attention(q, k, v, causal=True)
        grads_r = torch.autograd.grad((ref.float() ** 2).sum(), (q, k, v))
        e_op = (out.float() - ref.float()).abs().max().item()
        r_op = max((a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                   for a, b in zip(grads, grads_r))
        log(f"op vs dense oracle (2, 1000, 4, 64) {dtype} causal: out {e_op:.3e} "
            f"grads {r_op:.3e} rel")
        check(e_op < FWD_TOL and r_op < GRAD_TOL,
              f"flash op disagrees with the dense oracle in {dtype}")

    # model level: flash and dense losses of the same init agree
    losses = {}
    for flash in (True, False):
        tr = ShardedTrainer("transformer-long", batch_size=2, seq_len=256, flash_attn=flash)
        st = tr.init(seed=0)
        tok = tr.make_batch(seed=0)
        with torch.no_grad():
            losses[flash] = tr.loss(st.model(tok), tok).item()
        del st
    rel_loss = abs(losses[True] - losses[False]) / abs(losses[False])
    log(f"transformer-long init loss at S=256: flash {losses[True]:.6f} dense "
        f"{losses[False]:.6f} (rel {rel_loss:.2e})")
    check(math.isfinite(losses[True]) and rel_loss < LOSS_RTOL,
          "flash and dense model losses disagree at init")

    lap("3")
    # ---------------------------------------------------------------- 4 --
    b, s, h, d = MAIN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v, g = (torch.randn(MAIN_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = fa.attention_delta(out, g)
    ms = lambda fn, iters=20: time_callable(fn, iters=iters, warmup=3, device=dev) * 1e3  # noqa: E731
    times = {
        "flash_fwd": (ms(lambda: fa.flash_fwd(q, k, v, causal=True)),
                      ms(lambda: fa.flash_fwd_plain(q, k, v, True), 3)),
        "flash_bwd_dq": (ms(lambda: fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=True)),
                         ms(lambda: fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, True), 3)),
        "flash_bwd_dkdv": (ms(lambda: fa.flash_bwd_dkdv(q, k, v, g, lse, delta, causal=True)),
                           ms(lambda: fa.flash_bwd_dkdv_plain(q, k, v, g, lse, delta, True), 3)),
    }
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    sdpa_fwd_ms = ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    gt = g.transpose(1, 2)
    sdpa_bwd_ms = ms(lambda: torch.autograd.grad(o_sdpa, (qt, kt, vt), gt, retain_graph=True))
    # SDPA's flash backward computes dq, dk and dv in one call: the
    # yardstick of K2 and K3 together
    sdpa_flash_bwd_ms = sdpa_backward_ms(torch, q, k, v, g, ms)
    library = {"flash_fwd": sdpa_fwd_ms, "flash_bwd_dq": sdpa_flash_bwd_ms,
               "flash_bwd_dkdv": sdpa_flash_bwd_ms}
    bounds = {}
    for name in KERNELS:
        flops, nbytes = attention_cost(b, s, h, d, True, 2, name)
        bounds[name] = bound(flops, nbytes, peaks)
        k_ms, p_ms = times[name]
        log(f"time {name} {MAIN_SHAPE} bf16 causal: {k_ms:.4f} ms (plain {p_ms:.4f} ms, "
            f"bound {bounds[name][0]:.4f} ms by {bounds[name][1]}, "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
    # device time per launch beside the event time: at ~0.1 ms a call the
    # wrapper's host path comes close to the kernel's own time
    device_ms = {}
    for name, fn in (("flash_fwd", lambda: fa.flash_fwd(q, k, v, causal=True)),
                     ("flash_bwd_dq",
                      lambda: fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=True)),
                     ("flash_bwd_dkdv",
                      lambda: fa.flash_bwd_dkdv(q, k, v, g, lse, delta, causal=True))):
        cname = KERNELS[name][0]
        dev_ms, _ = device_ms_per_launch(fn, cname)
        device_ms[name] = dev_ms
        if dev_ms is None:
            log(f"device time {cname}: the profiler recorded no device time for it")
        else:
            ev_ms = times[name][0]
            what = "the host path" if ev_ms > 1.2 * dev_ms else "the kernel"
            log(f"device time {cname} {MAIN_SHAPE} bf16 causal: {dev_ms:.4f} ms per launch "
                f"(profiler) vs {ev_ms:.4f} ms per call (CUDA events): the event time "
                f"measured {what}")
    _, sdpa_kernels = device_ms_per_launch(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), "flash", 1)
    log(f"sdpa forward ran: {sdpa_kernels}")
    bwd_ms = times["flash_bwd_dq"][0] + times["flash_bwd_dkdv"][0]
    bwd_bound = bounds["flash_bwd_dq"][0] + bounds["flash_bwd_dkdv"][0]
    log(f"time sdpa forward {sdpa_fwd_ms:.4f} ms; K2+K3 {bwd_ms:.4f} ms "
        f"(plain {times['flash_bwd_dq'][1] + times['flash_bwd_dkdv'][1]:.4f} ms, "
        f"bound {bwd_bound:.4f} ms) vs sdpa backward {sdpa_bwd_ms:.4f} ms (autograd), "
        f"sdpa flash backward {sdpa_flash_bwd_ms:.4f} ms (dq, dk, dv in one call)")
    del q, k, v, g, qt, kt, vt, o_sdpa, out, lse, delta

    lap("4")
    # ---------------------------------------------------------------- 5 --
    trainer = ShardedTrainer("transformer-long", batch_size=2, seq_len=4096, flash_attn=True)
    state = trainer.init(seed=0)
    eager_state = trainer.init(seed=0)
    tokens = trainer.make_batch(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()                           # the main path starts here
    losses = []
    for _ in range(5):  # a warm-up, the capture and its replay, 3 replays
        state, loss = trainer.step(state, tokens)
        losses.append(loss.item())
    step_s, state = time_steps(trainer.step, state, tokens, iters=5, repeats=3)
    state, loss = trainer.step(state, tokens)
    losses.append(loss.item())
    launches = dict(fa.LAUNCHES)                  # ... and ends here
    n_steps = 5 + 5 * 3 + 1
    # the captured step against the trainer's eager path, from the same init
    eager_losses = []
    for _ in range(5):
        eager_state, loss = trainer._eager_step(eager_state, tokens)
        eager_losses.append(loss.item())
    capture_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, eager_losses))
    log(f"captured vs eager losses over 5 steps: {losses[:5]} vs {eager_losses} "
        f"(max rel {capture_rel:.2e}, bound {LOSS_RTOL})")
    check(capture_rel < LOSS_RTOL, "the captured step disagrees with the eager step")
    del eager_state
    state, update_rel = captured_update_check(torch, trainer, state, tokens, make_optimizer)
    # a replayed step waits for nothing on the host
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, loss = trainer.step(state, tokens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    before = dict(fa.LAUNCHES)
    flash_prof = profile_steps(torch, trainer, state, tokens,
                               kernels=[KERNELS[name][0] for name in KERNELS])
    window = {name: (fa.LAUNCHES[name] - before[name]) / flash_prof["steps_run"]
              for name in KERNELS}
    log(f"flash step profile: {json.dumps(flash_prof)}")
    check("device_ms_per_step" in flash_prof, f"flash step profile: {flash_prof}")
    flash_prof["busy_share_of_step"] = flash_prof["device_ms_per_step"] / (step_s * 1e3)
    seen = {name: flash_prof["launches_per_step"][KERNELS[name][0]] for name in KERNELS}
    log(f"launches a replayed step: counters {window}, profiler {seen}; device busy "
        f"{flash_prof['busy_share_of_step']:.3f} of an unprofiled step")
    check(seen == window, f"the profiler's kernels {seen} are not the counters' {window}")
    check(flash_prof["busy_share_of_step"] >= BUSY_MIN,
          f"the device is busy {flash_prof['busy_share_of_step']:.3f} of the flash step "
          f"(bound {BUSY_MIN})")
    flash_tps = 2 * 4096 / step_s
    cfg = trainer.cfg
    flash_tflops = cfg.flops_per_token_attn(4096) * 2 * 4096 / step_s / 1e12
    flash_mem = torch.cuda.max_memory_allocated() / 2**30
    log(f"flash train step transformer-long b2 S4096: {step_s * 1e3:.3f} ms/step, "
        f"{flash_tps:.1f} tokens/s, {flash_tflops:.2f} TFLOP/s attention-aware "
        f"(MFU {flash_tflops * 1e12 / peaks['bf16_flops']:.4f} of {card} bf16 peak), peak "
        f"{flash_mem:.2f} GiB, losses {losses}, launches {launches} over {n_steps} steps")
    check(all(math.isfinite(x) for x in losses), f"non-finite flash train loss: {losses}")
    check(losses[-1] < losses[0], f"flash train loss did not fall: {losses}")
    per_step = {name: launches[name] / n_steps for name in KERNELS}
    check(per_step["flash_fwd"] >= 8 and per_step["flash_bwd_dq"] >= 4
          and per_step["flash_bwd_dkdv"] >= 4,
          f"the train step did not run every kernel: {per_step} per step")
    del state, trainer, tokens
    torch.cuda.empty_cache()

    lap("5")
    # ---------------------------------------------------------------- 6 --
    before = dict(fa.LAUNCHES)
    trainer = ShardedTrainer("transformer-large", batch_size=16, seq_len=512)
    state = trainer.init(seed=0)
    tokens = trainer.make_batch(seed=0)
    dense_losses = []
    for _ in range(3):
        state, loss = trainer.step(state, tokens)
        dense_losses.append(loss.item())
    dense_s, state = time_steps(trainer.step, state, tokens, iters=10, repeats=3)
    dense_tps = 16 * 512 / dense_s
    dense_prof = profile_steps(torch, trainer, state, tokens)
    if "device_ms_per_step" in dense_prof:
        dense_prof["busy_share_of_step"] = dense_prof["device_ms_per_step"] / (dense_s * 1e3)
    log(f"dense step profile: {json.dumps(dense_prof)}")
    dense_mfu = trainer.cfg.flops_per_token() * 16 * 512 / dense_s / peaks["bf16_flops"]
    log(f"dense train step transformer-large b16 S512: {dense_s * 1e3:.3f} ms/step, "
        f"{dense_tps:.1f} tokens/s, MFU {dense_mfu:.4f} of {card} bf16 peak (6N FLOPs) on "
        f"{smi}; losses {dense_losses}")
    check(all(math.isfinite(x) for x in dense_losses), "non-finite dense train loss")
    check(dict(fa.LAUNCHES) == before, "the dense path launched a flash kernel")
    del state, trainer, tokens
    torch.cuda.empty_cache()

    lap("6")
    # ------------------------------------------------------------ 7 - 9 --
    probe_errs = probe_parity(torch, dev, (64, PROBE_N, 37, stages + 1))
    probe_launches, probe_times, probe_bounds = probe_sweeps(torch, dev, PROBE_N, ms, peaks)
    profile = profile_phase(torch, smi, dense_s)
    print(json.dumps({"profile": profile}))

    lap("7-9")
    # --------------------------------------------------------------- 10 --
    bench = bench_phase(torch)
    print(json.dumps({"bench": bench}))
    longctx_prof = longctx_profile(torch, fa, bench["longctx"]["step_ms"])
    longctx = longctx_kernels(torch, fa, dev, ms, peaks, F)
    for name, e in longctx["max_abs_err"].items():
        errs[name] = max(errs[name], e)
    bench_launches = {name: bench["flash"]["launches"][name] + bench["longctx"]["launches"][name]
                      for name in KERNELS}

    lap("10")
    # --------------------------------------------------------------- 11 --
    forms = f32_forms(torch, fa, dev, ms, peaks, F)
    ring = {"card": smi, "f32_forms": forms, "ring_flash": ring_vs_flash(torch, fa, dev, ms),
            "model": ring_model(torch, fa, dev), "dense_ring": dense_ring(torch, dev),
            "cli": ring_cli()}
    print(json.dumps({"ring": ring}))

    lap("11")
    # --------------------------------------------------------------- 12 --
    zoo = zoo_phase(torch, fa, ms, smi, peaks, profile)
    for name, e in zoo["moe_flash"]["parity"]["abs"].items():
        errs[name] = max(errs[name], e)
    print(json.dumps({"zoo": zoo}))

    lap("12")
    # --------------------------------------------------------------- 13 --
    ckpt = ckpt_phase(torch, fa, smi, step_s)
    print(json.dumps({"ckpt": ckpt}))

    lap("13")
    # --------------------------------------------------------------- 15 --
    first_losses = {"transformer-long": losses[0], "transformer-large": dense_losses[0],
                    "transformer-moe": zoo["cells"]["transformer-moe"]["losses"][0]}
    t0 = time.perf_counter()
    tp_kernels, pp_kernels, found, ranks_s = mesh_ranks(torch, fa, dev, ms, peaks, F)
    tp = tp_phase(smi, first_losses, tp_kernels, found)
    print(json.dumps({"tp": tp}))

    lap("15")
    # --------------------------------------------------------------- 16 --
    pp = pp_phase(smi, first_losses, pp_kernels, found)
    pp.update(ranks_s=ranks_s, phases_s=time.perf_counter() - t0)
    print(json.dumps({"pp": pp}))
    log(f"phases 15 and 16: {pp['phases_s']:.1f} s in all")
    for name in KERNELS:
        errs[name] = max(errs[name], tp["kernels"][name]["max_abs_err"],
                         pp["kernels"][name]["max_abs_err"])

    lap("16")
    # ----------------------------------------------------------- 17, 18 --
    print(json.dumps({"nccl": nccl_phase(torch, smi)}))
    print(json.dumps({"entry": entry_phase(torch)}))

    lap("17,18")
    # --------------------------------------------------------------- 19 --
    tools = tools_phase(torch, smi)
    print(json.dumps({"tools": tools}))
    for name in KERNELS:
        errs[name] = max(errs[name], tools["kernels"][name]["max_abs_err"])

    lap("19")
    # --------------------------------------------------------------- 20 --
    print(json.dumps({"sim": sim_phase(torch, fa, smi)}))

    lap("20")
    # ------------------------------------------------------- 21, 22, 23 --
    # phase 23's host processes start beside phase 21's and may run on
    # beside phase 22's; its two timed tools run after, alone on the host
    sweep_tmp = tempfile.mkdtemp(prefix="chip_smoke_sweeps_")
    try:
        sweeps = sweeps_start(sweep_tmp)
        try:
            print(json.dumps({"topology": topology_phase(smi)}))
            lap("21")
            print(json.dumps({"events": events_phase(smi)}))
            lap("22")
        except BaseException:
            sweeps.kill()
            raise
        found = sweeps_check(sweeps, sweep_tmp, smi)
        print(json.dumps({"sweeps": sweeps_timed(found, sweep_tmp, smi)}))
    finally:
        shutil.rmtree(sweep_tmp, ignore_errors=True)

    lap("23")
    log(f"phase wall seconds: {json.dumps(walls)}")
    # --------------------------------------------------------------- 14 --
    train = {
        "card": smi, "build_s": build_s,
        "flash": {"model": "transformer-long", "batch": 2, "seq": 4096,
                  "step_ms": step_s * 1e3, "tokens_per_s": flash_tps,
                  "tflops_attn_aware": flash_tflops, "peak_gib": flash_mem,
                  "losses": losses, "steps": n_steps, "launches": launches,
                  "captured_vs_eager_loss_rel": capture_rel,
                  "captured_update_rel": update_rel, "profile": flash_prof},
        "dense": {"model": "transformer-large", "batch": 16, "seq": 512,
                  "step_ms": dense_s * 1e3, "tokens_per_s": dense_tps, "mfu": dense_mfu,
                  "profile": dense_prof},
        "longctx": {"model": "transformer-xlong", "batch": 1, "seq": LONGCTX_SHAPE[1],
                    "profile": longctx_prof},
        "build": build_report, "device_ms_per_launch": device_ms, "phase_wall_s": walls,
        "backward": {"ms": bwd_ms, "bound_ms": bwd_bound,
                     "plain_ms": times["flash_bwd_dq"][1] + times["flash_bwd_dkdv"][1],
                     "library_ms": sdpa_bwd_ms, "sdpa_flash_backward_ms": sdpa_flash_bwd_ms},
    }
    kernels = [
        {"name": cname, "f32_kernel": f32_name, "route": "cuda", "source": SOURCE,
         "replaces": replaces, "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library[name], "launches_bench": bench_launches[name],
         "launches_moe_flash": zoo["moe_flash"]["launches"][name],
         "launches_ckpt": ckpt["in_process"]["launches"][name],
         "launches_tp_per_step_a_rank":
             tp["cells"]["transformer-long"]["launches_per_step"][0][name],
         "launches_pp_per_step_a_rank":
             pp["cells"]["transformer-long"]["launches_per_step"][0][name],
         "longctx": longctx["kernels"][name], "tp_shape": tp["kernels"][name],
         "pp_shape": pp["kernels"][name], "d128_shape": tools["kernels"][name],
         **({} if name == "flash_fwd" else {
             "library": "SDPA's flash backward: dq, dk and dv in one call, K2 and K3 together"})}
        for name, (cname, f32_name, replaces) in KERNELS.items()
    ] + [
        {"name": cname, "route": "cuda", "source": PROBE_SOURCE, "replaces": replaces,
         "launches": probe_launches[name], "max_abs_err": probe_errs[name],
         **probe_times[name], "bound_ms": probe_bounds[name][0],
         "bound_by": probe_bounds[name][1]}
        for name, (cname, replaces) in PROBE_KERNELS.items()
    ] + [
        {"name": f"{cname} (f32 out)", "route": "cuda", "source": SOURCE, "replaces": replaces,
         "call": call, "launches": ring["model"]["launches"][name],
         "max_abs_err": forms["max_abs_err"][name], **forms["times"][name]["past"],
         "diagonal_pair": forms["times"][name]["diagonal"]}
        for name, (cname, replaces, call) in F32_FORMS.items()
    ]
    print(json.dumps({"train": train}))
    print(json.dumps({"kernels": kernels}))
    return {"ok": True, "device": {"platform": "gpu", "kind": kind,
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    try:
        result = run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
