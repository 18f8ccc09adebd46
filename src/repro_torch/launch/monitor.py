"""Tail and summarize metrics JSONL — one file or a shard directory (the
port's copy of ``repro/launch/monitor.py``; it reads either package's
files, whose schema is the same).

Reads the snapshot stream written by ``repro_torch.obs.MetricsLogger`` (one
JSON object per line, schema documented in repro_torch/obs/metrics.py) and
renders the latest state: gauges at their last value, counters with a
rate derived from the two most recent snapshots, histograms with count
and estimated p50/p95 from their bucket counts. With ``--follow`` it
keeps watching the file and re-renders whenever new lines land — a
poor man's dashboard for a run on the other side of an ssh session.

``--merge`` points at a *directory* of per-process shard files (each
written by one ``MetricsLogger`` with its own ``proc`` label) and
reduces them into one logical snapshot before rendering. Reduction
follows the metric type: counters sum across shards, gauges resolve
last-write-wins by each shard's ``(ts, seq)`` order, and histograms add
bucket counts elementwise when their edges agree (on an edge mismatch
the earliest shard's buckets are kept — count/sum still aggregate).
This is the metrics plane for a multi-process trainer or a cross-host
serve fleet: each process appends to its own file, nobody coordinates.

  PYTHONPATH=src python -m repro_torch.launch.monitor /tmp/metrics.jsonl
  PYTHONPATH=src python -m repro_torch.launch.monitor /tmp/metrics.jsonl --follow
  PYTHONPATH=src python -m repro_torch.launch.monitor /tmp/mshards --merge
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Optional

from repro_torch.obs.metrics import hist_percentile


def read_snapshots(path: str) -> list[dict]:
    """Every parseable snapshot line (a truncated final line — a flush
    racing the reader — is skipped, not fatal; so is a missing file)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    snap = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(snap, dict) and "metrics" in snap:
                    out.append(snap)
    except (FileNotFoundError, IsADirectoryError):
        pass
    return out


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def merge_snapshots(snaps: list[dict]) -> dict:
    """Reduce one snapshot per shard into a single logical snapshot.

    Shards are folded in ``(ts, seq)`` order so "last write wins" for
    gauges is deterministic. Counters sum; histogram bucket counts add
    elementwise when edges match (else the first-seen buckets are kept
    and only count/sum aggregate). ``ts`` is the newest shard's; a
    ``procs`` field lists the contributing shard labels.
    """

    def order(s):
        return (s.get("ts", 0), s.get("seq", -1))

    merged: dict[tuple, dict] = {}
    procs = []
    for snap in sorted(snaps, key=order):
        proc = snap.get("proc")
        if proc is not None and proc not in procs:
            procs.append(proc)
        for m in snap.get("metrics", []):
            key = (m["name"], m["type"], _label_str(m.get("labels", {})))
            have = merged.get(key)
            if have is None:
                merged[key] = json.loads(json.dumps(m))  # deep copy
            elif m["type"] == "counter":
                have["value"] += m.get("value", 0)
            elif m["type"] == "gauge":
                have["value"] = m.get("value")  # sorted ⇒ last write wins
            else:  # histogram
                have["count"] = have.get("count", 0) + m.get("count", 0)
                have["sum"] = have.get("sum", 0.0) + m.get("sum", 0.0)
                if have.get("le") == m.get("le"):
                    have["bucket_counts"] = [
                        a + b for a, b in zip(have["bucket_counts"],
                                              m["bucket_counts"])
                    ]
    out = {
        "ts": max((s.get("ts", 0) for s in snaps), default=0),
        "metrics": sorted(merged.values(),
                          key=lambda m: (m["name"],
                                         _label_str(m.get("labels", {})))),
    }
    if procs:
        out["procs"] = procs
    return out


def load_merged(dir_path: str) -> list[dict]:
    """Merge a directory of per-process shard files into [prev, cur]
    logical snapshots (prev only when every non-empty shard has >= 2
    snapshots, so counter rates never mix window lengths)."""
    shards = [read_snapshots(p)
              for p in sorted(glob.glob(os.path.join(dir_path, "*.jsonl")))]
    shards = [s for s in shards if s]
    if not shards:
        return []
    cur = merge_snapshots([s[-1] for s in shards])
    if all(len(s) >= 2 for s in shards):
        return [merge_snapshots([s[-2] for s in shards]), cur]
    return [cur]


def load(path: str, merge: bool = False) -> list[dict]:
    """Snapshot history: a single file's lines, or a shard directory's
    [prev, cur] merged pair with ``merge``."""
    return load_merged(path) if merge else read_snapshots(path)


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v != 0 and abs(v) < 0.01:  # don't crush tiny fractions to 0.00
            return f"{v:.3g}"
        return f"{v:,.2f}"
    return f"{v:,}"


def counter_rate(cur_val, prev_val, dt) -> Optional[float]:
    """Per-second rate between snapshots, treating a negative delta as
    a counter reset (process restart within a shard): the current value
    IS the increase since the reset, so clamp rather than going
    negative."""
    if not dt or prev_val is None:
        return None
    delta = cur_val - prev_val
    if delta < 0:
        delta = cur_val
    return delta / dt


def render(snaps: list[dict], out=sys.stdout):
    """Render the newest snapshot (counter rates against the previous
    one when available)."""
    if not snaps:
        print("no snapshots yet", file=out)
        return
    cur = snaps[-1]
    prev = snaps[-2] if len(snaps) > 1 else None
    dt = cur["ts"] - prev["ts"] if prev is not None else None
    prev_vals = {}
    if prev is not None:
        for m in prev.get("metrics", []):
            key = (m["name"], _label_str(m.get("labels", {})))
            prev_vals[key] = m.get("value")
    age = time.time() - cur["ts"]
    procs = f" procs={','.join(cur['procs'])}" if cur.get("procs") else ""
    print(f"snapshot #{len(snaps)} ts={cur['ts']:.0f} "
          f"({age:.1f}s ago){procs}", file=out)
    rows = []
    for m in sorted(cur.get("metrics", []),
                    key=lambda m: (m["type"], m["name"])):
        name = m["name"] + _label_str(m.get("labels", {}))
        if m["type"] == "counter":
            extra = ""
            key = (m["name"], _label_str(m.get("labels", {})))
            rate = counter_rate(m["value"], prev_vals.get(key), dt)
            if rate is not None:
                extra = f"  ({rate:,.2f}/s)"
            rows.append(("counter", name, _fmt(m["value"]) + extra))
        elif m["type"] == "gauge":
            rows.append(("gauge", name, _fmt(m["value"])))
        else:  # histogram
            le = m.get("le", [])
            counts = m.get("bucket_counts", [])
            p50 = hist_percentile(le, counts, 50)
            p95 = hist_percentile(le, counts, 95)
            rows.append(("histogram", name,
                         f"n={m.get('count', 0):,}  p50={_fmt(p50)}  "
                         f"p95={_fmt(p95)}  sum={_fmt(m.get('sum'))}"))
    if not rows:
        print("  (empty registry)", file=out)
        return
    width = max(len(r[1]) for r in rows)
    last_kind = None
    for kind, name, val in rows:
        if kind != last_kind:
            print(f"-- {kind}s", file=out)
            last_kind = kind
        print(f"  {name:<{width}}  {val}", file=out)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="summarize / tail repro metrics JSONL "
                    "(a file, or a shard directory with --merge)"
    )
    ap.add_argument("path", help="metrics JSONL file (--metrics output), "
                                 "or a directory of shards with --merge")
    ap.add_argument("--merge", action="store_true",
                    help="treat PATH as a directory of per-process "
                         "*.jsonl shards and reduce them")
    ap.add_argument("--follow", action="store_true",
                    help="keep watching and re-render on new snapshots")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="poll cadence for --follow (seconds)")
    args = ap.parse_args(argv)
    last = None
    while True:
        snaps = load(args.path, merge=args.merge)
        sig = (len(snaps), snaps[-1]["ts"] if snaps else None)
        if sig != last:
            last = sig
            render(snaps)
        if not args.follow:
            return 0 if snaps else 1
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
