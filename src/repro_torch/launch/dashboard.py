"""Live ANSI terminal dashboard over a metrics JSONL stream (the port's
copy of ``repro/launch/dashboard.py``).

Where ``launch/monitor.py`` dumps every metric, the dashboard curates:
a TRAIN panel (iteration, tok/s, K* and log-likelihood sparklines,
delta-n sparsity, topic births/deaths, ESS / Geweke chain diagnostics,
per-phase wall-time fraction bars from ``train.phase_ms``) and a SERVE
panel (per-bucket queue depth, SLO hit rate, latency p50/p95). Panels
with no matching metrics are omitted, so the same tool reads a trainer
file, a serve-fleet file, or a merged multi-process directory.

Input is whatever ``monitor.load`` understands — one JSONL file, or a
shard directory with ``--merge`` (reduced per refresh via
``monitor.merge_snapshots``). Plain ANSI, no curses dependency: follow
mode repaints with an escape-clear, ``--once`` renders a single frame
(exit 1 when there are no snapshots).

  PYTHONPATH=src python -m repro_torch.launch.dashboard /tmp/metrics.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dashboard /tmp/mshards --merge
  PYTHONPATH=src python -m repro_torch.launch.dashboard /tmp/metrics.jsonl --once
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.launch.monitor import _label_str, counter_rate, load
from repro_torch.obs.metrics import hist_percentile

SPARK = "▁▂▃▄▅▆▇█"


def spark(values: list, width: int = 32) -> str:
    """Min-max normalized unicode sparkline of the last ``width``
    values ('' when empty; mid-band when the series is constant)."""
    vals = [float(v) for v in values if v is not None][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return SPARK[3] * len(vals)
    scale = (len(SPARK) - 1) / (hi - lo)
    return "".join(SPARK[int((v - lo) * scale)] for v in vals)


def bar(frac: float, width: int = 20) -> str:
    frac = min(max(frac, 0.0), 1.0)
    n = int(round(frac * width))
    return "#" * n + "." * (width - n)


def _metric_map(snap: dict) -> dict:
    """(name, label_str) -> metric dict for one snapshot."""
    return {(m["name"], _label_str(m.get("labels", {}))): m
            for m in snap.get("metrics", [])}


def _gauge(mm: dict, name: str):
    m = mm.get((name, ""))
    return m.get("value") if m else None


def _series(snaps: list[dict], name: str) -> list:
    """A no-label gauge/counter's value across the snapshot history."""
    out = []
    for s in snaps:
        for m in s.get("metrics", []):
            if m["name"] == name and not m.get("labels"):
                out.append(m.get("value"))
                break
    return out


def _labeled(mm: dict, name: str) -> list:
    """[(label_str, metric)] for every label set of ``name``."""
    return sorted((k[1], m) for k, m in mm.items() if k[0] == name)


def _fmt(v, nd=2) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:,.{nd}f}"
    return f"{v:,}"


def render(snaps: list[dict], out=sys.stdout):
    """One dashboard frame from the snapshot history."""
    if not snaps:
        print("no snapshots yet", file=out)
        return
    cur, prev = snaps[-1], (snaps[-2] if len(snaps) > 1 else None)
    mm = _metric_map(cur)
    pm = _metric_map(prev) if prev else {}
    dt = cur["ts"] - prev["ts"] if prev else None

    age = time.time() - cur["ts"]
    procs = f"  procs={','.join(cur['procs'])}" if cur.get("procs") else ""
    print(f"repro observatory  ts={cur['ts']:.0f} ({age:.1f}s ago)  "
          f"snapshots={len(snaps)}{procs}", file=out)

    # -- TRAIN -------------------------------------------------------------
    if any(k[0].startswith("train.") for k in mm):
        print("\n[train]", file=out)
        it = _gauge(mm, "train.it")
        tok = mm.get(("train.tokens_swept", ""))
        ptok = pm.get(("train.tokens_swept", ""))
        rate = counter_rate(tok["value"], ptok["value"] if ptok else None,
                            dt) if tok else None
        print(f"  iter {_fmt(it)}   tok/s {_fmt(rate, 0)}   "
              f"tokens {_fmt(tok['value'] if tok else None)}", file=out)
        for label, name in (("K*      ", "train.k_star"),
                            ("log_lik ", "train.log_lik")):
            ser = _series(snaps, name)
            if ser:
                print(f"  {label}{_fmt(ser[-1])}  {spark(ser)}", file=out)
        llt = _gauge(mm, "train.log_lik_per_token")
        dnz = _gauge(mm, "train.delta_nnz_frac")
        if llt is not None or dnz is not None:
            print(f"  ll/token {_fmt(llt, 4)}   delta_nnz_frac "
                  f"{_fmt(dnz, 4)}", file=out)
        births = mm.get(("train.topic_births", ""))
        deaths = mm.get(("train.topic_deaths", ""))
        if births or deaths:
            print(f"  topic births {_fmt(births['value'] if births else 0)}"
                  f"   deaths {_fmt(deaths['value'] if deaths else 0)}"
                  f"   drift {_fmt(_gauge(mm, 'train.top_word_drift'), 4)}",
                  file=out)
        ess_ll = _gauge(mm, "train.ess_log_lik")
        if ess_ll is not None:
            print(f"  ESS ll {_fmt(ess_ll)}  K* {_fmt(_gauge(mm, 'train.ess_k_star'))}"
                  f"   Geweke ll {_fmt(_gauge(mm, 'train.geweke_log_lik'))}"
                  f"  K* {_fmt(_gauge(mm, 'train.geweke_k_star'))}", file=out)
        ndev = _gauge(mm, "train.n_devices")
        drmb = _gauge(mm, "train.delta_reduce_mb")
        if ndev is not None and ndev > 1:
            print(f"  devices {_fmt(ndev)}   delta-reduce wire "
                  f"{_fmt(drmb, 3)} MB", file=out)
        phases = _labeled(mm, "train.phase_ms")
        total = sum(m["value"] for _, m in phases)
        if phases and total > 0:
            print("  phase fractions:", file=out)
            for label, m in sorted(phases, key=lambda lm: -lm[1]["value"]):
                # per-lane sweep walls carry a proc=dN label:
                # {phase=sweep,proc=d0} renders as sweep/d0
                name = (label.strip("{}").replace("phase=", "")
                        .replace(",proc=", "/"))
                frac = m["value"] / total
                print(f"    {name:<12} {bar(frac)} {frac * 100:5.1f}%",
                      file=out)

    # -- SERVE -------------------------------------------------------------
    if any(k[0].startswith("serve.") for k in mm):
        print("\n[serve]", file=out)
        for label, m in _labeled(mm, "serve.queue_depth"):
            print(f"  queue_depth{label}  {_fmt(m['value'])}", file=out)
        ok = sum(m["value"] for _, m in _labeled(mm, "serve.slo_ok"))
        miss = sum(m["value"] for _, m in _labeled(mm, "serve.slo_miss"))
        if ok + miss > 0:
            print(f"  SLO hit rate  {ok / (ok + miss) * 100:.1f}%  "
                  f"(ok={ok:,} miss={miss:,})", file=out)
        for label, m in _labeled(mm, "serve.latency_ms"):
            le, counts = m.get("le", []), m.get("bucket_counts", [])
            p50 = hist_percentile(le, counts, 50)
            p95 = hist_percentile(le, counts, 95)
            print(f"  latency{label}  n={m.get('count', 0):,}  "
                  f"p50={_fmt(p50)}ms  p95={_fmt(p95)}ms", file=out)

    # -- OBS self-state ----------------------------------------------------
    drops = _gauge(mm, "obs.trace_dropped_events")
    if drops:
        print(f"\nWARNING: trace dropped {drops:,} events (truncated)",
              file=out)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="live dashboard over repro metrics JSONL "
                    "(a file, or a shard directory with --merge)"
    )
    ap.add_argument("path", help="metrics JSONL file, or shard directory "
                                 "with --merge")
    ap.add_argument("--merge", action="store_true",
                    help="treat PATH as a directory of per-process "
                         "*.jsonl shards and reduce them")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (1 if no snapshots)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh cadence (seconds)")
    args = ap.parse_args(argv)
    history: list[dict] = []
    while True:
        snaps = load(args.path, merge=args.merge)
        if args.merge and snaps:
            # merged loads only yield [prev, cur]; accumulate frames so
            # sparklines grow over a follow session.
            if not history or snaps[-1]["ts"] != history[-1]["ts"]:
                history.extend(s for s in snaps
                               if not history or s["ts"] > history[-1]["ts"])
            snaps = history[-256:]
        if args.once:
            render(snaps)
            return 0 if snaps else 1
        sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
        render(snaps)
        sys.stdout.flush()
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
