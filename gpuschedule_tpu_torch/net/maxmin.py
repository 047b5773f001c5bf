"""Max-min fair bandwidth allocation by progressive filling.

The port's own copy of ``gpuschedule_tpu/net/maxmin.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_faults.py`` holds its results equal
to the original's, to the bit.

The contention solver at the heart of :mod:`gpuschedule_tpu_torch.net`: given a
set of flows (each loading a weighted set of links, each with a finite
offered demand) and per-link capacities, find the max-min fair rate
vector — the classic water-filling construction (Bertsekas & Gallager):
every unfrozen flow's rate rises at the same pace; a flow freezes when it
reaches its demand or when any link it loads saturates.  The result is
the unique allocation in which no flow's rate can be raised without
lowering that of another flow with an equal-or-smaller rate.

Weighted link loading: a flow ``f`` at rate ``r`` consumes
``w * r`` of each link it crosses with weight ``w`` (the fabric uses this
for the aggregation core, which carries every pod's injection of the same
allreduce).

Deterministic and pure Python (sim-core rule): flows are processed in
sorted-key order, arithmetic is plain floats, and two calls with the same
inputs return identical rates regardless of input ordering.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

# Relative freeze tolerance: a link whose remaining capacity is below
# _EPS x its original capacity is saturated; a flow within _EPS x demand
# of its demand is satisfied.  Floats only ever accumulate a handful of
# operations here, so 1e-9 is comfortably past any rounding residue.
_EPS = 1e-9


@dataclass(frozen=True)
class Flow:
    """One elastic demand: ``links`` are ``(name, weight)`` pairs."""

    key: str
    links: Tuple[Tuple[str, float], ...]
    demand: float


def _validate_flows(flows, capacity_gbps) -> None:
    if len({f.key for f in flows}) != len(flows):
        raise ValueError("duplicate flow keys")
    for f in flows:
        for link, w in f.links:
            if link not in capacity_gbps:
                raise ValueError(
                    f"flow {f.key!r} crosses unknown link {link!r}")
            if w <= 0:
                raise ValueError(
                    f"flow {f.key!r} has non-positive weight on {link!r}")


def _progressive_fill(
    active: Dict[str, Flow],
    rate: Dict[str, float],
    headroom: Dict[str, float],
    sat_floor: Dict[str, float],
) -> None:
    """The water-filling loop itself, mutating ``rate``/``headroom`` for
    ``active`` — shared VERBATIM by the flat solver and each bottleneck
    group's solve (:func:`maxmin_allocate_grouped`), so a one-group
    decomposition reproduces the flat arithmetic bit for bit."""
    while active:
        # weight of the active flow set on each loaded link
        wsum: Dict[str, float] = {}
        for f in active.values():
            for link, w in f.links:
                wsum[link] = wsum.get(link, 0.0) + w
        # the common rate increment: the first link to saturate or the
        # first demand to be met, whichever is nearer
        inc = min(headroom[link] / ws for link, ws in wsum.items())
        inc = min(inc, min(f.demand - rate[f.key] for f in active.values()))
        if inc > 0.0:
            for f in active.values():
                rate[f.key] += inc
                for link, w in f.links:
                    headroom[link] = max(0.0, headroom[link] - w * inc)
        saturated = {link for link in wsum if headroom[link] <= sat_floor[link]}
        frozen = [
            k for k, f in active.items()
            if rate[k] >= f.demand * (1.0 - _EPS)
            or any(link in saturated for link, _ in f.links)
        ]
        if not frozen:
            # unreachable for well-formed inputs (inc > 0 always saturates
            # a link or meets a demand); belt-and-braces against float
            # pathology so the solver can never spin
            break
        for k in frozen:
            del active[k]


def maxmin_allocate(
    flows: Iterable[Flow],
    capacity_gbps: Dict[str, float],
    *,
    validate: bool = True,
) -> Dict[str, float]:
    """Max-min fair rates for ``flows`` under ``capacity_gbps``.

    Every flow's links must exist in ``capacity_gbps``; capacities may be
    zero (flows crossing a dead link get rate 0).  Returns ``{flow.key:
    rate}`` for every input flow.

    ``validate=False`` skips the well-formedness sweep (duplicate keys,
    unknown links, non-positive weights) for callers that construct the
    flow set themselves and re-solve it repeatedly (the contention
    model's hot path); the arithmetic is identical either way.
    """
    flows = sorted(flows, key=lambda f: f.key)
    if validate:
        _validate_flows(flows, capacity_gbps)
    rate: Dict[str, float] = {f.key: 0.0 for f in flows}
    headroom = {k: max(0.0, float(v)) for k, v in capacity_gbps.items()}
    sat_floor = {k: _EPS * (1.0 + headroom[k]) for k in headroom}
    active: Dict[str, Flow] = {
        f.key: f for f in flows if f.demand > 0.0 and f.links
    }
    _progressive_fill(active, rate, headroom, sat_floor)
    return rate


# --------------------------------------------------------------------- #
# Bottleneck-group decomposition (partial re-solve)


@dataclass(frozen=True)
class GroupSolve:
    """One bottleneck group's cached solution: the exact inputs (member
    flows in key order, every loaded link's capacity) and the rates the
    fill derived from them.  Rates may be reused only when BOTH input
    tuples compare equal — bitwise-identical inputs into a deterministic
    pure solve give bitwise-identical outputs, which is the whole
    byte-identity argument."""

    flows: Tuple[Flow, ...]
    caps: Tuple[Tuple[str, float], ...]
    rates: Dict[str, float]


class GroupCache:
    """Across-recompute store of per-group solutions plus the reuse
    counters (``reused`` is the contention model's ``partial_solves``
    non-vacuity signal)."""

    def __init__(self) -> None:
        self.groups: Dict[Tuple[str, ...], GroupSolve] = {}
        self.reused = 0
        self.solved = 0


def _components(
    active: List[Flow], contended: set
) -> Tuple[Dict[int, List[Flow]], List[Flow]]:
    """Connected components of ``active`` over shared ``contended`` links
    (union-find), plus the *free* flows — those loading no contended link
    at all, which the fill would raise straight to their demand.  Both
    outputs are in deterministic key order (``active`` is pre-sorted)."""
    parent = list(range(len(active)))

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    anchor: Dict[str, int] = {}
    for i, f in enumerate(active):
        for link, w in f.links:
            if link in contended:
                j = anchor.setdefault(link, i)
                if j != i:
                    ri, rj = find(i), find(j)
                    if ri != rj:
                        parent[ri] = rj

    comps: Dict[int, List[Flow]] = {}
    free: List[Flow] = []
    for i, f in enumerate(active):
        if not any(link in contended for link, _ in f.links):
            free.append(f)
            continue
        comps.setdefault(find(i), []).append(f)
    return comps, free


def _solve_groups(
    comps: Dict[int, List[Flow]],
    capacity_gbps: Dict[str, float],
    rate: Dict[str, float],
    cache: Optional[GroupCache],
    *,
    exclude: Optional[str] = None,
) -> None:
    """Solve each component with the verbatim fill over its member flows
    and every link they load (slack ones included, at full capacity —
    they never bind, but keeping them preserves the flat loop's shape),
    reusing any cached :class:`GroupSolve` whose inputs are bitwise
    unchanged.  ``exclude`` drops one link from every solve — the
    hierarchical path's top tier, which is applied afterwards as a
    water-level clamp instead of riding each group's fill."""
    new_groups: Dict[Tuple[str, ...], GroupSolve] = {}
    for members in comps.values():
        key = tuple(f.key for f in members)   # members are in key order
        links = sorted({
            link for f in members for link, _ in f.links if link != exclude
        })
        caps = tuple((link, float(capacity_gbps[link])) for link in links)
        flows_t = tuple(members)
        hit = cache.groups.get(key) if cache is not None else None
        if hit is not None and hit.flows == flows_t and hit.caps == caps:
            rate.update(hit.rates)
            solve = hit
            cache.reused += 1
        else:
            grate = {f.key: 0.0 for f in members}
            headroom = {link: max(0.0, c) for link, c in caps}
            sat_floor = {
                link: _EPS * (1.0 + headroom[link]) for link in headroom
            }
            if exclude is None:
                fill_members = {f.key: f for f in members}
            else:
                fill_members = {
                    f.key: Flow(
                        f.key,
                        tuple(
                            (link, w) for link, w in f.links
                            if link != exclude
                        ),
                        f.demand,
                    )
                    for f in members
                }
            _progressive_fill(fill_members, grate, headroom, sat_floor)
            rate.update(grate)
            solve = GroupSolve(flows_t, caps, grate)
            if cache is not None:
                cache.solved += 1
        if cache is not None:
            new_groups[key] = solve
    if cache is not None:
        # only current components stay cached: a group that dissolved
        # (membership changed) can never be reused under the bitwise
        # signature anyway
        cache.groups = new_groups


def maxmin_allocate_grouped(
    flows: Iterable[Flow],
    capacity_gbps: Dict[str, float],
    *,
    cache: Optional[GroupCache] = None,
    validate: bool = True,
    top: Optional[str] = None,
) -> Dict[str, float]:
    """Max-min fair rates by **bottleneck-group decomposition** — the
    partial re-solve, extended with the **hierarchical
    top tier**.

    Links that cannot bind — offered load comfortably below capacity, so
    progressive filling could never saturate them — are *slack*; flows
    couple only through the **contended** links (load within the
    saturation tolerance of capacity).  Connected components over shared
    contended links solve independently: each group runs the verbatim
    :func:`_progressive_fill` loop over its member flows and every link
    they load (slack ones included, at full capacity — they never bind,
    but keeping them preserves the flat loop's shape), and a flow none of
    whose links are contended takes its full demand outright.

    ``top`` names the fabric's single globally-shared link (the
    oversubscribed aggregation core).  Without it, a contended core
    couples every flow into one monolithic component and the
    decomposition gets nothing.  With it,
    when the top link is contended the solve goes **hierarchical**:

    1. components form over the contended links *beneath* the top tier
       (per-pod uplink groups), each solved locally with the top link
       removed — progressive filling's dynamics cannot feel a constraint
       until it saturates, so below the core's waterline the local
       trajectories ARE the global ones;
    2. each local solve's final rates are the flows' *freeze levels*
       ``mu``; the core then binds every flow still active at its
       waterline ``lam`` — the unique level where
       ``sum(w_top * min(mu, lam)) == top capacity`` — and the global
       max-min rates are exactly ``min(mu, lam)`` in real arithmetic;
    3. the per-group local solves cache and reuse like any other group
       (a single-pod dirty set re-solves only that pod's group; the core
       clamp itself is a cheap exact re-derivation every pass).

    When the top tier never binds (slack by the 2x offered-load margin),
    when some active flow does not cross the top link (the clamp is only
    exact under the fabric invariant that ALL traffic transits the
    core), or when one local component spans every active flow anyway
    (nothing to decompose), the solve falls back to the non-hierarchical
    path —
    so slack-core fabrics and single-pod worlds keep their historical
    grouped arithmetic bit for bit, including the "one group spanning
    every flow reproduces the flat loop exactly" property.

    With a :class:`GroupCache`, a group whose inputs (member flows and
    all loaded-link capacities; the top link's capacity excluded for
    hierarchical groups — ingest churn moves it every pass) are bitwise
    unchanged since its last solve reuses the cached rates — the
    deterministic pure fill would redo identical arithmetic — so a dirty
    set touching one group re-solves only that group.  ``cache=None``
    solves every group fresh: the equivalence comparator, byte-identical
    by construction.

    The decomposition equals the flat solver exactly in real arithmetic
    (the hierarchical clamp to saturation-tolerance level, since the
    flat loop freezes the core within ``_EPS`` of capacity while the
    waterline is exact); across multiple groups the flat solver's global
    increment chunking re-associates float sums, so rates may differ in
    the last ulp — which is why the grouped arithmetic is an opt-in
    (``NetConfig.partial``) and the flat pass remains the no-flag
    fallback and oracle."""
    flows = sorted(flows, key=lambda f: f.key)
    if validate:
        _validate_flows(flows, capacity_gbps)
    rate: Dict[str, float] = {f.key: 0.0 for f in flows}
    active = [f for f in flows if f.demand > 0.0 and f.links]

    # per-link weighted offered load; a link is contended unless granting
    # every crossing flow its full demand leaves headroom comfortably
    # above the saturation floor (2x margin keeps borderline links in the
    # coupled set, so tolerance-level saturation can never differ between
    # a group solve and the flat loop)
    load: Dict[str, float] = {}
    for f in active:
        for link, w in f.links:
            load[link] = load.get(link, 0.0) + w * f.demand
    contended = set()
    for link, ld in load.items():
        cap = max(0.0, float(capacity_gbps[link]))
        if cap - ld < 2.0 * _EPS * (1.0 + cap):
            contended.add(link)

    # the hierarchical tier is exact only when EVERY active flow crosses
    # the top link (the fabric model's invariant: all traffic transits
    # the core).  A flow bypassing a contended top while sharing a
    # contended local link with a core-clamped flow could, in the flat
    # loop, keep filling the capacity the clamp freed — the water-level
    # clamp can only lower rates, never redistribute — so such instances
    # take the non-hierarchical path, which has no exactness caveat.
    if (
        top is not None
        and top in contended
        and all(any(link == top for link, _ in f.links) for f in active)
    ):
        local = contended - {top}
        comps, free = _components(active, local)
        if free or len(comps) > 1:
            # hierarchical: local solves beneath the top tier, then the
            # top tier's exact water-level clamp
            mu: Dict[str, float] = {}
            for f in free:
                mu[f.key] = f.demand
            _solve_groups(comps, capacity_gbps, mu, cache, exclude=top)
            return _clamp_to_top(active, mu, capacity_gbps, top, rate)
        # one component spans every active flow: nothing decomposes —
        # fall through to the non-hierarchical path, whose single group
        # (coupled via the contended top) IS the flat loop bit for bit

    comps, free = _components(active, contended)
    for f in free:
        # every link this flow loads can carry the whole offered load:
        # the fill would raise it straight to its demand
        rate[f.key] = f.demand
    _solve_groups(comps, capacity_gbps, rate, cache)
    return rate


def _clamp_to_top(
    active: List[Flow],
    mu: Dict[str, float],
    capacity_gbps: Dict[str, float],
    top: str,
    rate: Dict[str, float],
) -> Dict[str, float]:
    """Apply the top tier as a water-level clamp over the local freeze
    levels ``mu``: find the unique ``lam`` where the top link's consumed
    capacity ``sum(w * min(mu_f, lam))`` meets its capacity, and clamp
    every top-crossing flow there.  Flows not crossing the top link (and
    every flow, when the offered ``mu`` load fits outright) keep their
    local levels.  Deterministic: flows walk in ascending
    ``(mu, key)`` order, so every float sum has one canonical chunking —
    what makes cache-on and cache-off solves byte-identical."""
    weight: Dict[str, float] = {}
    for f in active:
        w = 0.0
        for link, lw in f.links:
            if link == top:
                w += lw
        weight[f.key] = w
    order = sorted((mu[f.key], f.key) for f in active if weight[f.key] > 0.0)
    top_cap = max(0.0, float(capacity_gbps[top]))
    total = 0.0
    wsum = 0.0
    for m, k in order:
        total += weight[k] * m
        wsum += weight[k]
    if total <= top_cap:
        # the top tier never binds at these freeze levels
        for f in active:
            rate[f.key] = mu[f.key]
        return rate
    below = 0.0
    wrem = wsum
    lam = order[-1][0] if order else 0.0
    for m, k in order:
        if below + m * wrem >= top_cap:
            lam = (top_cap - below) / wrem
            break
        below += weight[k] * m
        wrem -= weight[k]
    lam = max(0.0, lam)
    for f in active:
        k = f.key
        m = mu[k]
        rate[k] = min(m, lam) if weight[k] > 0.0 else m
    return rate
