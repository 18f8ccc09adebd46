"""The port's metrics monitor and dashboard (``repro_torch/launch/monitor.py``,
``launch/dashboard.py``): tests/test_monitor.py's cases on the port's
copy, and each package's ``load`` merging the other's files to the same
result (the snapshot schema is shared).
"""

import io
import json

import pytest

torch = pytest.importorskip("torch")

from repro.launch import monitor as JMON  # noqa: E402
from repro.obs.metrics import MetricsLogger as JLogger  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro_torch.launch import dashboard as DASH  # noqa: E402
from repro_torch.launch.monitor import (counter_rate, load, load_merged,  # noqa: E402
                                        merge_snapshots, read_snapshots, render)
from repro_torch.obs.metrics import MetricsLogger, MetricsRegistry  # noqa: E402


def _c(name, value, **labels):
    return {"name": name, "type": "counter", "labels": labels, "value": value}


def _g(name, value, **labels):
    return {"name": name, "type": "gauge", "labels": labels, "value": value}


def _h(name, le, counts, **labels):
    return {"name": name, "type": "histogram", "labels": labels,
            "count": sum(counts), "sum": 1.0, "le": list(le),
            "bucket_counts": list(counts)}


def _snap(ts, metrics, proc=None, seq=None):
    out = {"ts": ts, "metrics": metrics}
    if proc is not None:
        out["proc"] = proc
    if seq is not None:
        out["seq"] = seq
    return out


# -- reading ----------------------------------------------------------------------

def test_read_snapshots_tolerates_garbage_and_missing_files(tmp_path):
    p = tmp_path / "m.jsonl"
    good = _snap(1.0, [_c("c", 1)])
    p.write_text(json.dumps(good) + "\n" + "\n" + '{"ts": 2.0, "metr' + "\n"
                 + "[1, 2, 3]\n")
    assert read_snapshots(str(p)) == [good]
    assert read_snapshots(str(tmp_path / "nope.jsonl")) == []


# -- the merge ----------------------------------------------------------------------

def test_merge_sums_counters_and_gauges_take_the_last_write():
    merged = merge_snapshots([
        _snap(1.0, [_c("train.tokens_swept", 100)], proc="p0", seq=0),
        _snap(1.5, [_c("train.tokens_swept", 250)], proc="p1", seq=0)])
    assert merged["metrics"][0]["value"] == 350
    assert merged["ts"] == 1.5 and merged["procs"] == ["p0", "p1"]
    merged = merge_snapshots([_snap(2.0, [_g("train.k_star", 7)], proc="p1", seq=0),
                              _snap(1.0, [_g("train.k_star", 3)], proc="p0", seq=5)])
    assert merged["metrics"][0]["value"] == 7
    merged = merge_snapshots([_snap(1.0, [_g("g", 1)], proc="a", seq=9),
                              _snap(1.0, [_g("g", 2)], proc="b", seq=3)])
    assert merged["metrics"][0]["value"] == 1


def test_merge_histograms():
    (m,) = merge_snapshots([_snap(1.0, [_h("lat", [1.0, 2.0], [1, 2, 3], bucket=16)]),
                            _snap(2.0, [_h("lat", [1.0, 2.0], [4, 0, 1], bucket=16)])]
                           )["metrics"]
    assert m["bucket_counts"] == [5, 2, 4] and m["count"] == 11
    (m,) = merge_snapshots([_snap(1.0, [_h("lat", [1.0, 2.0], [1, 2, 3])]),
                            _snap(2.0, [_h("lat", [5.0, 9.0], [4, 0, 1])])])["metrics"]
    assert m["le"] == [1.0, 2.0] and m["bucket_counts"] == [1, 2, 3] and m["count"] == 11


def test_merge_keeps_label_sets_apart_and_inputs_untouched():
    merged = merge_snapshots([
        _snap(1.0, [_c("slo_ok", 1, bucket=16), _c("slo_ok", 2, bucket=32)]),
        _snap(2.0, [_c("slo_ok", 10, bucket=16)])])
    by_label = {json.dumps(m["labels"]): m["value"] for m in merged["metrics"]}
    assert by_label == {'{"bucket": 16}': 11, '{"bucket": 32}': 2}
    snap = _snap(1.0, [_h("lat", [1.0], [1, 1])])
    merge_snapshots([snap, _snap(2.0, [_h("lat", [1.0], [2, 2])])])
    assert snap["metrics"][0]["bucket_counts"] == [1, 1]


def test_load_merged_over_a_shard_dir(tmp_path):
    for proc, vals in (("p0", (10, 30)), ("p1", (5, 25))):
        with open(tmp_path / f"{proc}.jsonl", "w") as f:
            for seq, v in enumerate(vals):
                f.write(json.dumps(_snap(float(seq), [_c("tok", v)], proc=proc,
                                         seq=seq)) + "\n")
    prev, cur = load_merged(str(tmp_path))
    assert (prev["metrics"][0]["value"], cur["metrics"][0]["value"]) == (15, 55)
    assert load_merged(str(tmp_path / "missing")) == []
    one = tmp_path / "one"
    one.mkdir()
    with open(one / "p0.jsonl", "w") as f:
        f.write(json.dumps(_snap(1.0, [_c("c", 1)], proc="p0", seq=0)) + "\n")
        f.write(json.dumps(_snap(2.0, [_c("c", 2)], proc="p0", seq=1)) + "\n")
    with open(one / "p1.jsonl", "w") as f:
        f.write(json.dumps(_snap(2.0, [_c("c", 5)], proc="p1", seq=0)) + "\n")
    snaps = load_merged(str(one))
    assert len(snaps) == 1 and snaps[0]["metrics"][0]["value"] == 7


# -- rates and rendering --------------------------------------------------------------

def test_counter_rate_clamps_resets():
    assert counter_rate(150, 100, 10.0) == 5.0
    assert counter_rate(30, 100, 10.0) == 3.0
    assert counter_rate(30, None, 10.0) is None
    assert counter_rate(30, 100, None) is None


def test_render_smoke_degenerate_histograms_and_empty():
    buf = io.StringIO()
    render([
        _snap(1.0, [_c("c", 10), _g("g", 1.5), _h("empty", [1.0, 2.0], [0, 0, 0]),
                    _h("single", [4.0], [3, 0])]),
        _snap(2.0, [_c("c", 4), _g("g", 2.5), _h("empty", [1.0, 2.0], [0, 0, 0]),
                    _h("single", [4.0], [3, 0])]),
    ], out=buf)
    text = buf.getvalue()
    assert "(4.00/s)" in text and "p50=-" in text and "p50=2.00" in text
    assert "-- gauges" in text
    buf = io.StringIO()
    render([], out=buf)
    assert "no snapshots" in buf.getvalue()


# -- across the packages ---------------------------------------------------------------

def _write_shard(registry_cls, logger_cls, path, proc, offset):
    r = registry_cls()
    log = logger_cls(r, str(path), proc=proc)
    for step in range(3):
        r.counter("train.tokens_swept").inc(100 + offset)
        r.counter("train.phase_ms", phase="sweep", proc="d0").inc(2.5)
        r.gauge("train.k_star").set(step + offset)
        r.histogram("serve.latency_ms", bucket=32).observe(10.0 * (step + 1) + offset)
        log.flush(force=True)
    log.close()


def test_each_package_merges_the_others_shards_to_the_same_result(tmp_path):
    _write_shard(MetricsRegistry, MetricsLogger, tmp_path / "ours.jsonl", "ours", 0)
    _write_shard(JRegistry, JLogger, tmp_path / "ref.jsonl", "ref", 7)
    ours, ref = load(str(tmp_path), merge=True), JMON.load(str(tmp_path), merge=True)
    assert ours == ref and len(ours) == 2
    cur = {m["name"]: m for m in ours[-1]["metrics"]}
    assert cur["train.tokens_swept"]["value"] == 3 * 100 + 3 * 107
    assert cur["serve.latency_ms"]["count"] == 6
    for f in ("ours.jsonl", "ref.jsonl"):
        assert read_snapshots(str(tmp_path / f)) == JMON.read_snapshots(str(tmp_path / f))
    a, b = io.StringIO(), io.StringIO()
    render(ours, out=a)
    JMON.render(ref, out=b)
    assert a.getvalue() == b.getvalue()


def test_dashboard_renders_a_trainer_file_once(tmp_path):
    path = tmp_path / "m.jsonl"
    _write_shard(MetricsRegistry, MetricsLogger, path, "p", 0)
    buf = io.StringIO()
    DASH.render(load(str(path)), out=buf)
    assert "[train]" in buf.getvalue() and "sweep/d0" in buf.getvalue()
    assert DASH.main([str(tmp_path / "missing.jsonl"), "--once"]) == 1
