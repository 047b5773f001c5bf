"""Port parity for the event stream and its consumers.

The config hash (``worldspec.py``), ``run --events`` with its header,
``--perfetto`` and ``obs export``, the analysis document (in memory and
spilled to sqlite), ``report`` (HTML and ``--json``, with ``--low-mem``,
``--selfprof`` and ``--alerts``), ``compare`` (the two-run gate's JSON and
exit codes, the n-way matrix), ``history`` and ``--self-profile``: each
the JAX package's to the byte, on the 300-job Philly sample.  What
differs on every run (a profile's wall seconds, a history row's ``ts``)
is held by its structure.
"""

import argparse
import gzip
import json
import shutil
from pathlib import Path

import pytest

from gpuschedule_tpu import cli as jax_cli, worldspec as jax_worldspec
from gpuschedule_tpu import obs as jax_obs
from gpuschedule_tpu_torch import cli, obs, worldspec

from torch_sim_parity import PHILLY_SAMPLE, errors_alike, run_both

MAINS = (("jax", jax_cli.main), ("port", cli.main))
STREAM_RUNS = {
    "dlas": ["--policy", "dlas", "--attrib", "--sample-interval", "3600", "--cache-stats"],
    "fifo": ["--policy", "fifo"],
    "srtf": ["--policy", "srtf"],
    "other-seed": ["--policy", "fifo", "--synthetic", "150", "--seed", "9"],
}


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """Each package's event streams of ``STREAM_RUNS`` on the Philly sample
    (the last on a synthetic world of another seed), the DLAS run with
    ``--perfetto``, ``--self-profile`` and ``--history``; the stdout lines
    and every file equal between the packages."""
    tmp = tmp_path_factory.mktemp("streams")
    out = {}
    for side, main in MAINS:
        d = tmp / side
        for name, argv in STREAM_RUNS.items():
            world = [] if "--synthetic" in argv else ["--philly", PHILLY_SAMPLE]
            extra = ["--perfetto", str(d / "dlas.trace.json"), "--self-profile",
                     str(d / "dlas.prof.json")] if name == "dlas" else []
            assert main(["run", *world, *argv, *extra, "--events", "--history",
                         str(d / "h.db"), "--out", str(d / name)]) == 0
        out[side] = d
    for name in STREAM_RUNS:
        for f in ("events.jsonl", "jobs.csv", "counters.json"):
            assert (out["jax"] / name / f).read_bytes() == (out["port"] / name / f).read_bytes()
    return out


def _parsed(main, argv):
    """The namespace each CLI's ``run`` parser makes of ``argv``."""
    if main is cli.main:
        return cli.build_parser().parse_args(["run", *argv])
    got = []
    orig = jax_cli.cmd_run
    jax_cli.cmd_run = got.append
    try:
        jax_cli.main(["run", *argv])
    finally:
        jax_cli.cmd_run = orig
    return got[0]


@pytest.mark.parametrize("argv", [
    [],
    ["--philly", "data/philly_10k.csv", "--cluster", "tpu-v5p"],
    ["--synthetic", "200", "--seed", "42", "--cluster", "simple", "--chips", "128"],
    ["--cluster", "gpu", "--gpu-shape", "4x8x8", "--placement", "random", "--placement-seed", "3"],
    ["--cluster", "tpu-v5e", "--dims", "4x4", "--pods", "8", "--net"],
    ["--net", "os=2,uplinks=2", "--placement", "contention"],
    ["--accounting", "v2", "--max-time", "5000"],
    ["--faults", "mtbf=86400,repair=3600,ckpt=1800", "--arrival-rate", "0.01",
     "--mean-duration", "600", "--failure-rate", "0.1", "--util-min", "0.5",
     "--max-job-chips", "64"],
    ["--trace", "t.csv", "--policy", "dlas", "--attrib", "--events", "--accounting", "v1"],
], ids=lambda a: "_".join(a)[:40] or "defaults")
def test_config_hash_equals_jax(argv):
    """Every world flag gives the JAX package's hash dict and digest, so
    the ``run_id`` and the events header are the same."""
    ours, ref = _parsed(cli.main, argv), _parsed(jax_cli.main, argv)
    assert worldspec.hash_config(ours) == jax_worldspec.hash_config(ref)
    assert cli._run_config_hash(ours) == jax_cli._run_config_hash(ref)


def test_worldspec_tables_and_run_dests():
    """The three buckets are the JAX package's, every dest of the port's
    ``run`` parser sits in one of them, and each hashed dest has the JAX
    parser's default."""
    assert worldspec.HASHED == jax_worldspec.HASHED
    assert worldspec.HASHED_WHEN_ARMED == jax_worldspec.HASHED_WHEN_ARMED
    assert set(worldspec.UNHASHED) == set(jax_worldspec.UNHASHED)
    ours, ref = _parsed(cli.main, []), _parsed(jax_cli.main, [])
    dests = set(vars(ours)) - {"cmd", "fn", "device"}
    buckets = set(worldspec.HASHED) | set(worldspec.HASHED_WHEN_ARMED) | set(worldspec.UNHASHED)
    assert dests <= buckets
    assert dests == set(vars(ref)) - {"cmd", "fn"}
    for dest in (*worldspec.HASHED, *worldspec.HASHED_WHEN_ARMED):
        assert getattr(ours, dest) == getattr(ref, dest), dest
    assert obs.config_hash({"a": 1}) == jax_obs.config_hash({"a": 1})


def test_events_perfetto_and_export_equal_jax(streams, capsys, tmp_path):
    """The stream (header first), the ``--perfetto`` trace and ``obs
    export`` of the stream are the JAX package's bytes; the trace is
    valid and its export is the run's own file."""
    for name in STREAM_RUNS:
        head = json.loads((streams["port"] / name / "events.jsonl").open().readline())
        assert "event" not in head and head["schema"] == 1
        assert head["run_id"].startswith(STREAM_RUNS[name][1])
    trace = {side: (streams[side] / "dlas.trace.json").read_bytes() for side, _ in MAINS}
    assert trace["jax"] == trace["port"]
    doc = json.loads(trace["port"])
    assert obs.validate_chrome_trace(doc) == []
    assert {"occupancy", "sample"} <= {e.get("cat") for e in doc["traceEvents"]}
    lines = []
    for side, main in MAINS:
        assert main(["obs", "export", "--events", str(streams[side] / "dlas" / "events.jsonl"),
                     "--out", str(tmp_path / f"{side}.json")]) == 0
        lines.append(json.loads(capsys.readouterr().out))
        assert (tmp_path / f"{side}.json").read_bytes() == trace["port"]
    assert lines[0]["trace_events"] == lines[1]["trace_events"] == len(doc["traceEvents"])


def test_trace_events_of_hand_streams_equal_jax():
    """Fault and repair, net and netlink, migrate and reject records, and
    the fleet merge, through both exporters."""
    events = [
        {"schema": 1, "run_id": "x"},
        {"event": "start", "t": 0.0, "job": "a", "track": "pod0/4x4@0,0", "why": {"r": 1}},
        {"event": "start", "t": 1.0, "job": "b", "track": "pod0/4x4@4,0"},
        {"event": "fault", "t": 2.0, "scope": "pod0", "fid": 1, "fault": "mtbf"},
        {"event": "fault", "t": 2.5, "scope": "pod0", "fid": 2, "fault": "domain"},
        {"event": "net", "t": 3.0, "job": "a", "bw": 1.5},
        {"event": "netlink", "t": 3.0, "link": "pod0-up", "util": 0.5},
        {"event": "netlink", "t": 4.0, "link": "pod0-up", "util": 0.25},
        {"event": "migrate", "t": 5.0, "job": "a", "track": "pod1/4x4@0,0"},
        {"event": "repair", "t": 6.0, "scope": "pod0", "fid": 1},
        {"event": "reject", "t": 6.5, "job": "c"},
        {"event": "preempt", "t": 7.0, "job": "b"},
        {"event": "sample", "t": 7.5, "used": 16, "unhealthy": 4, "pending": 2,
         "pods": [{"hazard": 0.1}, {"hazard": 0.2}]},
        {"event": "finish", "t": 8.0, "job": "a", "end_state": "done"},
    ]
    ours = obs.trace_events(events)
    assert ours == jax_obs.trace_events(events)
    assert obs.validate_chrome_trace({"traceEvents": ours}) == []
    assert obs.validate_chrome_trace({"traceEvents": [{"ph": "Q"}]}) == \
        jax_obs.validate_chrome_trace({"traceEvents": [{"ph": "Q"}]})
    spans = [{"name": "s", "ph": "X", "ts": 3.0, "dur": 1.0}]
    workers = {"w1": [{"name": "t", "ph": "X", "ts": 1.0, "dur": 2.0}], "w0": spans}
    assert obs.fleet_trace_events(spans, workers) == jax_obs.fleet_trace_events(spans, workers)


@pytest.mark.parametrize("low_memory", [False, True], ids=["in-memory", "low-memory"])
def test_analysis_documents_equal_jax(low_memory, streams, tmp_path):
    """``analyze_file``'s document and summary are the JAX package's, in
    memory and spilled to sqlite, and so is the JSON dump of a gzip
    stream.  (The spilled dump is not always the in-memory one's bytes,
    in either package: ROADMAP Queue 3.)"""
    for name in STREAM_RUNS:
        path = streams["port"] / name / "events.jsonl"
        ours = obs.analyze_file(path, low_memory=low_memory)
        ref = jax_obs.analyze_file(path, low_memory=low_memory)
        assert ours.to_json() == ref.to_json()
        assert ours.summary() == ref.summary()
        assert ours.header.to_json() == ref.header.to_json()
    gz = tmp_path / "dlas.jsonl.gz"
    with open(streams["port"] / "dlas" / "events.jsonl", "rb") as f, gzip.open(gz, "wb") as g:
        shutil.copyfileobj(f, g)
    ours = obs.analyze_file(gz, low_memory=low_memory)
    ours.write_json(tmp_path / "ours.json")
    jax_obs.analyze_file(gz, low_memory=low_memory).write_json(tmp_path / "ref.json")
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "ref.json").read_bytes()


@pytest.mark.parametrize("flags", [[], ["--low-mem"], ["--alerts", "{alerts}"],
                                   ["--no-header", "--title", "T & <b>"]],
                         ids=["plain", "low-mem", "alerts", "title"])
def test_report_html_and_json_equal_jax(flags, streams, capsys, tmp_path):
    """``report`` writes the JAX package's HTML and ``--json`` document,
    and the same stdout line."""
    alerts = tmp_path / "alerts.jsonl"
    alerts.write_text("\n".join(json.dumps(r) for r in [
        {"schema": 1, "kind": "alerts"},
        {"event": "alert", "t": 7200.0, "detector": "queue_depth", "severity": "warn",
         "value": 12, "threshold": 10, "cause": "capacity"},
        {"event": "alert", "t": 90000.5, "detector": "wait_p99", "severity": "page",
         "value": 4000.25, "threshold": 3600, "cause": "policy-preempt"},
        {"event": "note", "t": 1.0},
    ]) + "\n")
    flags = [f.replace("{alerts}", str(alerts)) for f in flags]
    lines = []
    for side, main in MAINS:
        assert main(["report", "--events", str(streams[side] / "dlas" / "events.jsonl"),
                     "--json", str(tmp_path / f"{side}.json"),
                     "--out", str(tmp_path / f"{side}.html"), *flags]) == 0
        lines.append(json.loads(capsys.readouterr().out))
    for ext in ("html", "json"):
        assert (tmp_path / f"jax.{ext}").read_bytes() == (tmp_path / f"port.{ext}").read_bytes()
    assert {k: v for k, v in lines[0].items() if k != "report"} == \
        {k: v for k, v in lines[1].items() if k != "report"}
    html = (tmp_path / "port.html").read_text()
    assert ("<h2>Alerts</h2>" in html) == ("--alerts" in flags)
    assert "Engine health" in html  # the cache-telemetry table of --cache-stats


def test_report_selfprof_panel(streams, capsys, tmp_path):
    """``report --selfprof`` embeds the wall seconds of the profile it is
    given, so it is held by what it shows: exit 0 and the Engine-health
    panel's phase bar, from either package's profile, and the same HTML
    from the same profile."""
    html = []
    for side, main in MAINS:
        assert main(["report", "--events", str(streams["port"] / "dlas" / "events.jsonl"),
                     "--selfprof", str(streams["port"] / "dlas.prof.json"),
                     "--out", str(tmp_path / f"{side}.html")]) == 0
        capsys.readouterr()
        html.append((tmp_path / f"{side}.html").read_text())
    assert html[0] == html[1]
    assert "Engine health" in html[1] and "event_apply" in html[1]


def test_self_profile_documents_alike(streams):
    """The same phases, batches and run identity as the JAX package's
    profile of the same run; the phases sum to the total."""
    docs = {side: json.loads((streams[side] / "dlas.prof.json").read_text()) for side, _ in MAINS}
    ours, ref = docs["port"]["selfprof"], docs["jax"]["selfprof"]
    assert list(ours["phases"]) == list(ref["phases"]) == sorted(obs.PHASES)
    assert obs.PHASES == jax_obs.PHASES
    assert ours["batches"] == ref["batches"] > 0
    wall = {"total_wall_s", "batches_per_s", "phases"}
    assert {k: v for k, v in ours.items() if k not in wall} == \
        {k: v for k, v in ref.items() if k not in wall}
    assert sum(p["total_s"] for p in ours["phases"].values()) == pytest.approx(
        ours["total_wall_s"], rel=1e-12)
    assert docs["port"]["otherData"] == docs["jax"]["otherData"]
    assert obs.load_profile(streams["port"] / "dlas.prof.json") == ours
    blocks = {"w0": [ours, ref], "w1": [ref]}
    assert obs.merge_profiles(blocks) == jax_obs.merge_profiles(blocks)


@pytest.mark.parametrize("case", ["within", "regressed", "mismatch", "allowed", "matrix",
                                  "one-stream", "matrix-threshold"])
def test_compare_json_and_exit_codes_equal_jax(case, streams, capsys, tmp_path):
    """``compare``: 0 within thresholds, 1 regressed, 2 not comparable
    (another seed, without ``--allow-mismatch``), the three-stream matrix,
    and the usage refusals; the JAX CLI's exit code, table and JSON."""
    names, flags = {
        "within": (["dlas", "dlas"], []),
        "regressed": (["dlas", "fifo"], ["--threshold", "0.05", "--threshold", "wait_p99=0.5"]),
        "mismatch": (["fifo", "other-seed"], []),
        "allowed": (["fifo", "other-seed"], ["--allow-mismatch"]),
        "matrix": (["dlas", "fifo", "srtf"], ["--low-mem"]),
        "one-stream": (["dlas"], []),
        "matrix-threshold": (["dlas", "fifo", "srtf"], ["--threshold", "0.1"]),
    }[case]
    got = []
    for side, main in MAINS:
        paths = [str(streams[side] / n / "events.jsonl") for n in names]
        rc = main(["compare", *paths, "--json", str(tmp_path / f"{side}.json"), *flags])
        out, err = capsys.readouterr()
        written = (tmp_path / f"{side}.json")
        got.append((rc, out, err, written.read_bytes() if written.exists() else None))
    assert got[0] == got[1]
    want = {"within": 0, "regressed": 1, "mismatch": 2, "allowed": None, "matrix": 0,
            "one-stream": 2, "matrix-threshold": 2}[case]
    if want is not None:
        assert got[1][0] == want


def test_history_rows_equal_jax_but_ts(streams, capsys, tmp_path):
    """``run --history`` and ``compare --history`` append the JAX
    package's rows (all but ``ts``); ``history list``/``trend`` print the
    same, and so do the library's ``rows``/``render_trend``."""
    got = []
    for side, main in MAINS:
        store = streams[side] / "h.db"
        assert main(["compare", str(streams[side] / "fifo" / "events.jsonl"),
                     str(streams[side] / "srtf" / "events.jsonl"), "--history", str(store)]) in (0, 1)
        capsys.readouterr()
        printed = []
        for argv in (["list"], ["trend", "--metric", "avg_jct", "--metric", "makespan"],
                     ["list", "--kind", "compare", "--last", "1"], ["trend", "--config", "nope"]):
            assert main(["history", *argv, "--store", str(store),
                         "--json", str(tmp_path / f"{side}.json")]) == 0
            printed.append(capsys.readouterr())
        rows = json.loads((tmp_path / f"{side}.json").read_text())
        got.append((printed, [{k: v for k, v in r.items() if k != "ts"} for r in rows]))
    assert got[0] == got[1]
    with obs.HistoryStore(streams["port"] / "h.db") as ours, \
            jax_obs.HistoryStore(streams["jax"] / "h.db") as ref:
        a, b = ours.rows(), ref.rows()
        assert len(a) == len(STREAM_RUNS) + 2
        strip = [{**vars(r), "ts": None} for r in a]
        assert strip == [{**vars(r), "ts": None} for r in b]
        assert obs.render_trend(a, ["avg_jct"]) == jax_obs.render_trend(b, ["avg_jct"])
        assert obs.trend_delta(a, "avg_jct") == jax_obs.trend_delta(b, "avg_jct")
    for side, main in MAINS:
        with pytest.raises(SystemExit) as e:
            main(["history", "list", "--store", str(tmp_path / "none.db")])
        assert str(e.value) == f"history store {tmp_path / 'none.db'} does not exist"


@pytest.mark.parametrize("argv", [
    ["--events"],
    ["--flush-events", "0"],
    ["--flush-events", "-1", "--events", "{tmp}/e.jsonl"],
    ["--snapshot", "{tmp}/s.pkl"],
    ["--snapshot-every", "60"],
    ["--snapshot", "{tmp}/s.pkl", "--snapshot-every", "-5"],
    ["--resume", "{tmp}/missing.pkl"],
    ["--resume", "{tmp}/missing.pkl", "--perfetto", "{tmp}/t.json"],
    ["--accounting", "v3"],
    ["--events", "--resume", "{tmp}/missing.pkl"],
], ids=lambda a: "_".join(a).replace("{tmp}/", ""))
def test_new_flag_errors_equal_jax(argv, capsys, tmp_path):
    """Every refusal of the new flags is the JAX CLI's, word for word."""
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    if argv == ["--accounting", "v3"]:
        for _, main in MAINS:
            with pytest.raises(SystemExit) as e:
                main(["run", "--synthetic", "5", *argv])
            assert e.value.code == 2
        assert capsys.readouterr().err.count("invalid choice: 'v3'") == 2
        return
    errors_alike(capsys, ["--synthetic", "5", *argv])


@pytest.mark.parametrize("argv", [
    ["report", "--events", "{tmp}/none.jsonl", "--out", "{tmp}/r.html"],
    ["report", "--events", "{bare}", "--out", "{tmp}/r.html"],
    ["report", "--events", "{stream}", "--selfprof", "{stream}", "--out", "{tmp}/r.html"],
    ["report", "--events", "{stream}", "--alerts", "{tmp}/none.jsonl", "--out", "{tmp}/r.html"],
    ["compare", "{stream}", "{stream}", "--threshold", "x=y"],
], ids=["missing-stream", "no-header", "not-a-profile", "missing-alerts", "bad-threshold"])
def test_consumer_errors_equal_jax(argv, streams, capsys, tmp_path):
    """The report's and compare's refusals are the JAX CLI's."""
    bare = tmp_path / "bare.jsonl"
    bare.write_text('{"event": "arrival", "t": 0.0, "job": "a"}\n')
    argv = [a.replace("{tmp}", str(tmp_path)).replace("{bare}", str(bare))
            .replace("{stream}", str(streams["port"] / "dlas" / "events.jsonl")) for a in argv]
    msgs = []
    for _, main in MAINS:
        with pytest.raises(SystemExit) as e:
            main(argv)
        msgs.append(str(e.value))
    capsys.readouterr()
    assert msgs[0] == msgs[1]


def test_run_perfetto_without_events_and_flush_cadence(capsys, tmp_path):
    """``--perfetto`` alone (the events held in memory), ``--events PATH``
    without ``--out`` and a flush cadence: the JAX package's bytes."""
    for argv, files in (
            (["--perfetto", "{out}/t.json", "--policy", "dlas"], ("t.json", "jobs.csv")),
            (["--events", "{out}/e.jsonl", "--flush-events", "3600", "--sample-on-change",
              "--faults", "mtbf=20000,repair=1800"], ("e.jsonl", "counters.json"))):
        run_both(capsys, tmp_path / argv[0], ["--synthetic", "60", "--seed", "1", *argv],
                 files=files)


def test_stream_cursor_and_readers_equal_jax(streams):
    """The incremental reader gives the JAX package's items for a stream
    fed in ragged chunks, and both refuse a truncated record alike."""
    text = (streams["port"] / "fifo" / "events.jsonl").read_text()[:20000]
    got = []
    for mod in (obs, jax_obs):
        cur = mod.StreamCursor("s")
        items = []
        for i in range(0, len(text), 777):
            items += cur.feed(text[i:i + 777])
        with pytest.raises(mod.StreamError) as e:
            cur.finish()
        got.append((items, str(e.value)))
    assert got[0] == got[1]
    path = streams["port"] / "srtf" / "events.jsonl"
    assert list(obs.iter_jsonl_items(path)) == list(jax_obs.iter_jsonl_items(path))


def test_port_parsers_accept_every_jax_run_flag():
    """``run`` has each flag of the JAX CLI's ``run``, with its type and
    choices (``--device`` is the port's own)."""
    def flags(parser):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return {a.dest: (tuple(a.option_strings), a.nargs, a.const, a.default, a.type,
                         tuple(a.choices) if a.choices else None)
                for a in sub.choices["run"]._actions if a.dest != "help"}

    captured = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, *args, **kw):
        captured["p"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            jax_cli.main(["run"])
    finally:
        argparse.ArgumentParser.parse_args = orig
    ours, ref = flags(cli.build_parser()), flags(captured["p"])
    ours.pop("device")
    policy = ours.pop("policy"), ref.pop("policy")
    assert policy[0][:4] == policy[1][:4]
    assert ours == ref
    for name in ("report", "compare", "history", "obs"):
        assert name in next(a for a in cli.build_parser()._actions
                            if isinstance(a, argparse._SubParsersAction)).choices


def test_chip_smoke_events_header_is_the_jax_header(tmp_path):
    """``chip_smoke.py`` holds phase 22's streams to pins copied from the
    JAX package (it cannot import it): recompute the stream header, which
    carries the config hash of the phase's world, from the JAX package's
    parser, hash and writer, and the port's the same way."""
    import sys

    from gpuschedule_tpu.cluster import TpuCluster as JaxTpu
    from gpuschedule_tpu.policies import make_policy as jax_make_policy
    from gpuschedule_tpu.sim import Simulator as JaxSimulator
    from gpuschedule_tpu.sim.job import Job as JaxJob
    from gpuschedule_tpu.sim.metrics import MetricsLog as JaxLog
    from gpuschedule_tpu_torch.cluster import TpuCluster
    from gpuschedule_tpu_torch.policies import make_policy
    from gpuschedule_tpu_torch.sim import Simulator
    from gpuschedule_tpu_torch.sim.job import Job
    from gpuschedule_tpu_torch.sim.metrics import MetricsLog

    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    argv = [a.replace("{tmp}", str(tmp_path)) for a in chip_smoke.EVENTS_REPLAYS["dlas"]]
    for side, main, sim_cls, tpu, make, log_cls, job in (
            ("jax", jax_cli.main, JaxSimulator, JaxTpu, jax_make_policy, JaxLog, JaxJob),
            ("port", cli.main, Simulator, TpuCluster, make_policy, MetricsLog, Job)):
        args = _parsed(main, argv[1:])
        chash = (cli if side == "port" else jax_cli)._run_config_hash(args)
        sink = tmp_path / f"{side}.jsonl"
        log = log_cls(record_events=True, events_sink=sink, run_meta={
            "run_id": f"{args.policy}-s{args.seed}-{chash}", "seed": args.seed,
            "policy": args.policy, "config_hash": chash})
        with log:
            sim_cls(tpu("v5p"), make(args.policy), [job("a", 0.0, 4, 60.0)], metrics=log).run()
        assert sink.read_text().splitlines()[0] == chip_smoke.EVENTS_HEADER
    for cmds in (chip_smoke.EVENTS_REPLAYS, chip_smoke.EVENTS_READERS, chip_smoke.EVENTS_HISTORY,
                 {"resume": chip_smoke.EVENTS_RESUME}):
        for argv in cmds.values():
            cli.build_parser().parse_args(list(argv))
