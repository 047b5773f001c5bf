"""Port parity for the topology slice: Gandiva and Themis, the GPU cluster
and its placement schemes, the TPU placement schemes and
``compare-topology``, at tolerance zero.

Each case runs one command line through both packages' CLIs (in this
process): the summary lines must be equal and every file under ``--out``
byte-equal (``jobs.csv``, ``utilization.csv``, ``counters.json``,
``metrics.prom``, ``metrics.json``; for ``compare-topology``,
``summary.json``, every ``cdf_*.csv`` and ``report.md``).  Then the
refusals both CLIs share, and the copied constant tables.
"""

import inspect

import pytest
from torch_sim_parity import PHILLY_SAMPLE, counters, errors_alike, run_both

from gpuschedule_tpu import analysis as jax_analysis
from gpuschedule_tpu.cluster import gpu as jax_gpu
from gpuschedule_tpu.placement import schemes as jax_schemes
from gpuschedule_tpu.policies import available as jax_available
from gpuschedule_tpu.policies import gandiva as jax_gandiva
from gpuschedule_tpu.policies import make_policy as jax_make_policy
from gpuschedule_tpu.policies import themis as jax_themis
from gpuschedule_tpu_torch import analysis
from gpuschedule_tpu_torch.cluster import gpu
from gpuschedule_tpu_torch.placement import schemes
from gpuschedule_tpu_torch.policies import available, gandiva, make_policy, themis

CLUSTERS = {
    "simple": ["--cluster", "simple", "--chips", "64"],
    "v5e-8x8": ["--cluster", "tpu-v5e", "--dims", "8x8"],
    "v5p-2pods": ["--cluster", "tpu-v5p", "--pods", "2"],
}
TRACES = {
    "synthetic": ["--synthetic", "200", "--seed", "42"],
    "philly-sample": ["--philly", PHILLY_SAMPLE],
}
# 4 pods of 16 chips: room for the TPU schemes to choose between pods
V5E_PODS = ["--cluster", "tpu-v5e", "--dims", "4x4", "--pods", "4", "--synthetic", "200",
            "--seed", "42"]


@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("policy", ["gandiva", "themis"])
def test_gandiva_and_themis_equal_jax(policy, cluster, trace, capsys, tmp_path):
    got = run_both(capsys, tmp_path, ["--policy", policy, *CLUSTERS[cluster], *TRACES[trace]])
    assert got["num_finished"] == got["arrivals"] > 0
    if policy == "gandiva":
        # time-slicing, migration or grow-shrink ran
        assert any(got.get(k, 0) > 0 for k in ("preemptions", "migrations", "grows"))
    else:
        assert "p95_slowdown" in got and got["max_slowdown"] >= 1.0


@pytest.mark.parametrize("policy", ["fifo", "gandiva"])
@pytest.mark.parametrize("scheme,seed", [("consolidated", 0), ("random", 0), ("random", 1),
                                         ("greedy", 0), ("topology", 0)])
def test_gpu_schemes_equal_jax(scheme, seed, policy, capsys, tmp_path):
    """The switch -> node -> GPU tree of 2 x 4 x 8 under each scheme; random
    at two placement seeds.  ``topology`` refuses a gang that no NVLink
    island holds."""
    got = run_both(capsys, tmp_path, [
        "--policy", policy, "--cluster", "gpu", "--placement", scheme,
        "--placement-seed", str(seed), "--synthetic", "100", "--seed", "42"])
    assert got["num_finished"] + got["num_rejected"] == got["arrivals"] == 100.0
    assert got["num_unfinished"] == 0
    assert (got["num_rejected"] > 0) == (scheme == "topology")


def test_gpu_random_scheme_follows_its_seed(capsys, tmp_path):
    """Two placement seeds give two different replays, each equal to JAX's."""
    got = [run_both(capsys, tmp_path / str(seed), [
        "--cluster", "gpu", "--placement", "random", "--placement-seed", str(seed),
        "--synthetic", "200", "--seed", "42"]) for seed in (0, 1)]
    assert got[0] != got[1]


@pytest.mark.parametrize("policy", ["fifo", "themis"])
@pytest.mark.parametrize("scheme", ["random", "spread", "contention", "health"])
def test_tpu_schemes_equal_jax(scheme, policy, capsys, tmp_path):
    """The TPU schemes over four v5e 4x4 pods: ``contention`` with the
    fabric model, ``health`` with a hazard knob armed."""
    extra = {"contention": ["--net"],
             "health": ["--faults", "mtbf=86400,hazard_shape=2,hazard_util=2"]}.get(scheme, [])
    got = run_both(capsys, tmp_path, ["--policy", policy, *V5E_PODS, "--placement", scheme,
                                      "--placement-seed", "3", *extra])
    assert got["num_finished"] == got["arrivals"] == 200.0
    if scheme == "contention":
        assert counters(tmp_path)["net_reprices"] > 0
    if scheme == "health":
        assert counters(tmp_path)["faults"] > 0


def test_compare_topology_equal_jax(capsys, tmp_path):
    """Eight replays (two random-scheme seeds) and the load sweep: the
    stdout line equal, ``summary.json``, the CDFs and ``report.md``
    byte-equal."""
    names = ["gpu-consolidated", "gpu-random-s0", "gpu-random-s1", "gpu-topology", "tpu-v5e",
             "tpu-v5p", "tpu-v5p-2pod", "tpu-v5p-2pod-net"]
    got = run_both(capsys, tmp_path, ["--synthetic", "100", "--seeds", "2", "--load-sweep"],
                   files=["summary.json", "report.md", *(f"cdf_{n}.csv" for n in names)],
                   cmd="compare-topology")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    for name in names:
        assert got[name]["num_finished"] == 100
    assert set(got["acceptance"]) >= {"jct_delta_pct", "makespan_delta_pct", "within_5pct"}
    assert got["gpu-random-mean"]["seeds"] == 2 and len(got["load_sweep"]) == 4


@pytest.mark.parametrize("argv", [
    ["--cluster", "gpu", "--placement", "spread"],
    ["--placement", "nowhere"],
    ["--placement", "contention"],
    ["--cluster", "gpu", "--net"],
])
def test_placement_refusals_alike(argv, capsys):
    """An unknown or mismatched scheme, ``contention`` without the fabric,
    and ``--net`` on a GPU cluster: both CLIs refuse with one message."""
    assert errors_alike(capsys, [*argv, "--synthetic", "5"])


def test_copied_tables_equal_the_originals():
    assert gpu.SCHEMES == jax_gpu.SCHEMES
    assert gpu.DEFAULT_LOCALITY_SPEED == jax_gpu.DEFAULT_LOCALITY_SPEED
    assert schemes.TPU_SCHEMES == jax_schemes.TPU_SCHEMES
    assert gandiva.DEFAULT_GROWTH_CURVE.theta == jax_gandiva.DEFAULT_GROWTH_CURVE.theta
    assert analysis.ACCEPTANCE_THRESHOLD_PCT == jax_analysis.ACCEPTANCE_THRESHOLD_PCT
    assert available() == jax_available()
    for ours, ref in ((gandiva.GandivaPolicy, jax_gandiva.GandivaPolicy),
                      (themis.ThemisPolicy, jax_themis.ThemisPolicy),
                      (gpu.GpuCluster, jax_gpu.GpuCluster)):
        mine = inspect.signature(ours.__init__).parameters
        theirs = inspect.signature(ref.__init__).parameters
        assert {k: p.default for k, p in mine.items()} == \
            {k: p.default for k, p in theirs.items()}, ours.__name__
    for name in ("gandiva", "themis"):
        assert type(make_policy(name)).rule_codes == type(jax_make_policy(name)).rule_codes
