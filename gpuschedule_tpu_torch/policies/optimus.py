"""Optimus: goodput-driven elastic allocation by marginal gain.

The port's own copy of ``gpuschedule_tpu/policies/optimus.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_sim*.py`` hold its replays equal
to the original's, to the bit.

The Optimus scheduler (EuroSys'18; SURVEY.md §3.2) re-plans the whole
cluster each round from per-model goodput curves:

1. every active job's remaining time at k chips is estimated from its
   fitted step-time curve (remaining work scaled by the curve ratio);
2. chips are assigned greedily — every job seeds at ``min_chips``, then
   the upgrade with the best **marginal gain** (remaining-time reduction
   per added chip) wins the next doubling, until the pod is exhausted or
   no upgrade helps (the curve's latency term makes oversized slices
   genuinely unprofitable, so the greedy loop self-terminates);
3. the plan is enacted through the engine: shrink/preempt first to free
   chips, then grow, then start — growth is a slice-size doubling because
   TPU allocations are power-of-two sub-meshes, where the reference grew
   GPU counts one at a time.

Curves come from a :class:`~gpuschedule_tpu_torch.profiler.CurveCache` (device-
free replay, SURVEY.md §4 "pre-fitted curve files") or, with
``online=True``, from the port's harness the first time each model is
seen: :func:`gpuschedule_tpu_torch.profiler.harness.profile_model` measures
the model's train step on ``device`` (the card unless the caller passes
``device="cpu"``) — the reference's "launch a profiling run when a new job
type arrives" loop with a measured step instead of NCCL microbenchmarks
(BASELINE.json config #4).  As in the JAX package, only a ``ValueError``
(a layout the harness cannot measure here) falls back to a stored or the
default curve; a failed build, launch or CUDA call fails the replay.
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, Optional

from gpuschedule_tpu_torch.policies.base import Policy
from gpuschedule_tpu_torch.profiler.goodput import CurveCache, GoodputCurve
from gpuschedule_tpu_torch.sim.job import Job, JobState

# Fallback when no curve exists and online profiling is off: near-ideal DP
# scaling with a whisper of latency so oversizing still has a cost.
DEFAULT_CURVE = GoodputCurve((1.0, 0.0, 1e-4))


class OptimusPolicy(Policy):
    name = "optimus"

    # stable cause-code tokens (attribution layer): the four
    # moves the marginal-gain planner can make on a job each round
    rule_codes = {
        "plan-evicted": "evict",
        "plan-shrink": "shrink",
        "plan-grow": "grow",
        "plan-start": "start",
    }

    def __init__(
        self,
        *,
        curve_cache: Optional[CurveCache] = None,
        online: bool = False,
        round_interval: float = 60.0,
        resize_overhead: float = 10.0,
        min_chips: int = 1,
        profile_ks=(1, 2, 4),
        profile_batch: int = 2,
        profile_seq: int = 32,
        profile_iters: int = 10,
        profile_warmup: int = 2,
        profile_compile_s: float = 30.0,
        profile_time_cost: Optional[float] = None,
        device=None,
    ):
        self.cache = curve_cache
        self.device = device
        self.online = online
        self.round_interval = round_interval
        self.resize_overhead = resize_overhead
        self.min_chips = min_chips
        self.profile_ks = tuple(profile_ks)
        self.profile_batch = profile_batch
        self.profile_seq = profile_seq
        self.profile_iters = int(profile_iters)
        self.profile_warmup = int(profile_warmup)
        self.profile_compile_s = float(profile_compile_s)
        # Profiling is NOT free in simulated time (the
        # reference's profiling runs consume real cluster resources,
        # SURVEY.md §3.2 ★): the first job of each online-profiled model
        # pays a start overhead — its slice is held but makes no training
        # progress, the engine's overhead mechanism — before real work
        # begins.  Cache-hit models pay nothing, so a warm CurveCache is
        # measurably better than a cold one.  By default the charge is
        # DERIVED from the profiling workload itself (a
        # flat constant ignores that the harness cost scales with
        # profile_ks and iters): per profiled k, one compile plus
        # (warmup + iters) steps at that k's fitted step time.  A float
        # here overrides with the old flat charge.
        self.profile_time_cost = (
            None if profile_time_cost is None else float(profile_time_cost)
        )
        self._curves: Dict[str, GoodputCurve] = {}
        self._profile_charge_pending: Dict[str, float] = {}
        # the scheduled cluster's pod boundary, captured each schedule()
        # call: DCN-cliff planning must use the fleet's real pod size, not
        # the nominal generation pod the curve was profiled against
        self._cluster_pod: Optional[int] = None

    # ------------------------------------------------------------------ #
    # curves

    @staticmethod
    def _curve_key(job: Job) -> str:
        """Cache key for a job's curve: the @sp{s}tp{t}[pp{p}] variant
        when the job declares a parallelism spec, else the bare model
        name — the consumer side of profile_model's variant keys
        (harness.py)."""
        sp = getattr(job, "sp", 1)
        tp = getattr(job, "tp", 1)
        pp = getattr(job, "pp", 1)
        if sp == 1 and tp == 1 and pp == 1:
            return job.model_name
        if pp == 1:
            return f"{job.model_name}@sp{sp}tp{tp}"
        return f"{job.model_name}@sp{sp}tp{tp}pp{pp}"

    def _profile_charge(self, curve: GoodputCurve, ks=None) -> float:
        """Simulated seconds one online-profiling run occupies its slice:
        per profiled k, a compile plus (warmup + iters) steps at the
        fitted step time — so more ks, more iters, or a slower model all
        raise the charge the way they raise the real harness cost."""
        if self.profile_time_cost is not None:
            return self.profile_time_cost
        steps = self.profile_warmup + self.profile_iters
        return sum(
            self.profile_compile_s + steps * curve.step_time(k)
            for k in (self.profile_ks if ks is None else ks)
        )

    def _job_curve(self, job: Job) -> GoodputCurve:
        key = self._curve_key(job)
        curve = self._curves.get(key)
        if curve is not None:
            return curve
        if self.cache is not None and key in self.cache:
            curve = self.cache.get(key)
        elif self.online:
            # the reference's online-profiling boundary (SURVEY.md §3.2 ★):
            # a real measured run, here the train step on the card
            from gpuschedule_tpu_torch.profiler.harness import profile_model

            sp = getattr(job, "sp", 1)
            tp = getattr(job, "tp", 1)
            pp = getattr(job, "pp", 1)
            unit = sp * tp * pp
            # profile_model requires ks divisible by the replica unit:
            # profile at replica multiples for parallelism-spec jobs
            ks = tuple(k * unit for k in self.profile_ks) if unit > 1 else self.profile_ks
            try:
                curve = profile_model(
                    job.model_name,
                    ks=ks,
                    batch_size=self.profile_batch,
                    seq_len=self.profile_seq,
                    sp=sp,
                    tp=tp,
                    pp=pp,
                    cache=self.cache,
                    device=self.device,
                )
            except ValueError:
                # unmeasurable here (e.g. one replica spans more devices
                # than this host exposes): a degraded curve must not
                # abort the whole simulation — fall back like the
                # offline path, with no profiling charge (nothing ran)
                curve = (
                    self.cache.get(job.model_name)
                    if self.cache is not None and job.model_name in self.cache
                    else DEFAULT_CURVE
                )
            else:
                charge = self._profile_charge(curve, ks=ks)
                if charge > 0.0:
                    self._profile_charge_pending[key] = charge
        elif self.cache is not None and job.model_name in self.cache:
            # offline, no measured variant: the bare-model curve beats the
            # featureless default.  (Online runs never take this branch —
            # the variant deserves its own profile; a bare-model cache hit
            # must not shadow it.)
            curve = self.cache.get(job.model_name)
        else:
            curve = DEFAULT_CURVE
        self._curves[key] = curve
        return curve

    # ------------------------------------------------------------------ #

    def schedule(self, sim) -> Optional[float]:
        self._cluster_pod = getattr(sim.cluster, "pod_chips", None)
        active = [j for j in sim.pending + sim.running if not j.finished]
        if not active:
            return None
        plan = self._plan(sim, active)
        self._enact(sim, plan)
        # Anchor the next tick to the global round grid, NOT now + interval:
        # per-event offsets never coincide, so free-running chains seeded by
        # every arrival/completion would multiply into O(events x horizon)
        # tick storms; grid-aligned ticks land on equal timestamps and the
        # engine batches them into one policy invocation.
        return (math.floor(sim.now / self.round_interval) + 1) * self.round_interval

    # ------------------------------------------------------------------ #
    # planning

    def _remaining_at(self, job: Job, k: int) -> float:
        """Wall seconds to finish job on k chips per its curve (the curve
        ratio rescales the trace-declared reference-speed work).

        Planning uses ``step_time_dcn``: beyond one pod the analytic DCN
        allreduce phase degrades the estimate, so marginal gain sees the
        ICI->DCN cliff — comm-heavy models decline whale growth that
        compute-heavy models accept."""
        curve = self._job_curve(job)
        pod = self._cluster_pod
        return (
            job.remaining_work
            * curve.step_time_dcn(k, pod_chips=pod)
            / curve.step_time_dcn(job.num_chips, pod_chips=pod)
        )

    def _gain(self, job: Job, k: int) -> float:
        """Marginal remaining-time reduction per chip for doubling k."""
        return (self._remaining_at(job, k) - self._remaining_at(job, 2 * k)) / k

    def _max_chips(self, sim, job: Job) -> int:
        """Growth ceiling: one pod for curves that carry no DCN model (a
        smooth extrapolation across the pod boundary would overestimate
        multislice gain), the whole fleet for multislice-aware curves —
        the cliff in step_time_dcn is then what self-terminates growth."""
        pod = getattr(sim.cluster, "pod_chips", sim.cluster.total_chips)
        # the payload is what makes the DCN phase computable; the boundary
        # itself comes from the scheduled cluster (_remaining_at)
        if self._job_curve(job).dcn_grad_bytes is not None:
            return sim.cluster.total_chips
        return pod

    def _plan(self, sim, active) -> Dict[str, int]:
        """Greedy marginal-gain chip assignment; returns job_id -> chips."""
        budget = sim.cluster.total_chips
        ordered = sorted(active, key=lambda j: j.arrival_seq)
        plan: Dict[str, int] = {}
        by_id: Dict[str, Job] = {}
        for job in ordered:
            by_id[job.job_id] = job
            # one model replica spans sp*tp*pp chips: a parallelism-spec
            # job cannot seed below its replica size
            k0 = max(
                self.min_chips,
                getattr(job, "sp", 1)
                * getattr(job, "tp", 1)
                * getattr(job, "pp", 1),
            )
            if budget >= k0 and sim.cluster.is_satisfiable(k0):
                plan[job.job_id] = k0
                budget -= k0
            else:
                plan[job.job_id] = 0

        h: list = []
        for job in ordered:
            k = plan[job.job_id]
            if k > 0:
                g = self._gain(job, k)
                if g > 0:
                    heapq.heappush(h, (-g, job.arrival_seq, job.job_id))
        while h and budget > 0:
            _, seq, jid = heapq.heappop(h)
            job = by_id[jid]
            k = plan[jid]
            nk = 2 * k
            cost = nk - k
            if (
                cost > budget
                or nk > self._max_chips(sim, job)
                or not sim.cluster.is_satisfiable(nk)
            ):
                continue
            plan[jid] = nk
            budget -= cost
            g = self._gain(job, nk)
            if g > 0:
                heapq.heappush(h, (-g, seq, jid))
        return plan

    # ------------------------------------------------------------------ #
    # enactment

    def _speed(self, job: Job, k: int) -> float:
        """Enacted progress rate: the PLAIN (DCN-free) curve ratio.  The
        engine multiplies in the DCN toll itself via job.locality_factor
        (cluster `_multislice_speed_factor`); using step_time_dcn here
        would charge a multislice job the toll twice."""
        return self._job_curve(job).speed_factor(k, job.num_chips)

    def _enact(self, sim, plan: Dict[str, int]) -> None:
        ex = self.explaining(sim)

        def why(job: Job, rule: str, k: int):
            if not ex:
                return None
            # the marginal gain that justified (or failed to justify) the
            # planned size: remaining-time reduction per chip of the next
            # doubling, the quantity the greedy planner ranked on
            d = {"planned_chips": k}
            if k > 0:
                d["marginal_gain_s_per_chip"] = round(self._gain(job, k), 6)
            return self.explain(rule, **d)

        # shrink & evict first: frees chips (and boxes) for the growers
        for job in list(sim.running):
            k = plan.get(job.job_id, 0)
            if k == 0:
                sim.preempt(job, suspend=False, why=why(job, "plan-evicted", k))
            elif k < job.allocated_chips:
                sim.resize(
                    job, chips=k, speed=self._speed(job, k),
                    overhead=self.resize_overhead,
                    why=why(job, "plan-shrink", k),
                )
        for job in list(sim.running):
            k = plan.get(job.job_id, 0)
            if k > job.allocated_chips:
                sim.resize(
                    job, chips=k, speed=self._speed(job, k),
                    overhead=self.resize_overhead,
                    why=why(job, "plan-grow", k),
                )
        for job in sorted(sim.pending, key=lambda j: j.arrival_seq):
            k = plan.get(job.job_id, 0)
            if k > 0:
                overhead = self.resize_overhead if job.executed_work > 0.0 else 0.0
                # The first job of a freshly online-profiled model carries
                # the profiling run: its slice is occupied for the derived
                # charge (see _profile_charge) before training progresses.
                key = self._curve_key(job)
                charge = self._profile_charge_pending.get(key, 0.0)
                if (
                    sim.try_start(
                        job, chips=k, speed=self._speed(job, k),
                        overhead=overhead + charge,
                        why=why(job, "plan-start", k),
                    )
                    and charge > 0.0
                ):
                    self._profile_charge_pending.pop(key, None)
                    sim.metrics.count("profiling_runs")
