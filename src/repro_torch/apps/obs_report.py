"""Reader CLI for ``repro_torch.obs`` Chrome-trace exports.

``python -m repro_torch.apps.obs_report trace.json`` prints four sections:

* **span tree** — ``"X"`` complete events re-nested by ts/dur
  containment per (pid, tid), aggregated by path (count, total, self);
* **top-N self time** — spans ranked by exclusive time;
* **counters** — every metric series from the ``repro_metrics``
  snapshot (histograms show count/mean/min/max);
* **decisions** — the ``repro_decisions`` log: per-source counts plus
  the chosen config, predicted time, and runner-up candidates of each
  record.

The port's own copy of the JAX package's reader
(``repro/apps/obs_report.py``): both packages write the same trace
format (``repro_torch/obs/trace.py::export_trace``), and the same
payload gives the same report text.  The file is the plain Chrome trace
event format, so the same trace also loads in Perfetto /
``chrome://tracing``.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict


def _build_tree(events):
    """Nest ``X`` events by containment per (pid, tid); aggregate nodes
    by path.  Returns {path_tuple: [count, total_us, self_us]}."""
    agg: dict = defaultdict(lambda: [0, 0.0, 0.0])
    by_thread: dict = defaultdict(list)
    for e in events:
        if e.get("ph") == "X":
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        # children have later ts and earlier (or equal) end; sorting by
        # (ts, -dur) visits parents before their children
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list = []            # [(end_us, path, node)]
        for e in evs:
            ts, dur = e["ts"], e["dur"]
            while stack and ts >= stack[-1][0] - 1e-9:
                stack.pop()
            path = (stack[-1][1] if stack else ()) + (e["name"],)
            node = agg[path]
            node[0] += 1
            node[1] += dur
            node[2] += dur
            if stack:
                stack[-1][2][2] -= dur      # parent's self time
            stack.append((ts + dur, path, node))
    return dict(agg)


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.1f}ms"
    return f"{us:.0f}us"


def _print_tree(agg, out):
    print("== span tree (count · total · self) ==", file=out)
    if not agg:
        print("  (no spans)", file=out)
        return
    for path in sorted(agg):        # parents sort before their children
        count, total, self_us = agg[path]
        indent = "  " * len(path)
        print(f"{indent}{path[-1]}  ×{count}  {_fmt_us(total)}  "
              f"(self {_fmt_us(self_us)})", file=out)


def _print_top_self(agg, n, out):
    by_name: dict = defaultdict(lambda: [0, 0.0])
    for path, (count, _total, self_us) in agg.items():
        by_name[path[-1]][0] += count
        by_name[path[-1]][1] += self_us
    print(f"\n== top {n} spans by self time ==", file=out)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n]
    if not ranked:
        print("  (no spans)", file=out)
    for name, (count, self_us) in ranked:
        print(f"  {_fmt_us(self_us):>10}  ×{count:<5} {name}", file=out)


def _print_counters(metrics, out):
    print("\n== counters / gauges / histograms ==", file=out)
    if not metrics:
        print("  (no metrics)", file=out)
        return
    for name in sorted(metrics):
        for labels, value in sorted(metrics[name].items()):
            series = f"{name}{{{labels}}}" if labels else name
            if isinstance(value, dict):
                mean = value["sum"] / max(1, value["count"])
                print(f"  {series}: count={value['count']} "
                      f"mean={mean:.3g}s min={value['min']:.3g}s "
                      f"max={value['max']:.3g}s", file=out)
            else:
                v = f"{value:g}" if isinstance(value, float) else value
                print(f"  {series}: {v}", file=out)


def _print_decisions(decisions, out, limit=10):
    print(f"\n== decisions ({len(decisions)} recorded) ==", file=out)
    by_source: dict = defaultdict(int)
    for d in decisions:
        by_source[d.get("source", "?")] += 1
    for src, n in sorted(by_source.items()):
        print(f"  {src}: {n}", file=out)
    for d in decisions[:limit]:
        t = d.get("predicted_seconds")
        t_s = f" pred={t * 1e6:.1f}us" if t is not None else ""
        cal = d.get("calibration")
        cal_s = f" cal={cal}" if cal else ""
        print(f"  - {d.get('source')} op={d.get('op')} dim={d.get('dim')} "
              f"H={d.get('heads')} → {tuple(d.get('chosen', ()))}"
              f"{t_s}{cal_s}", file=out)
        for c in d.get("topk", [])[1:3]:
            v = c.get("seconds")
            v_s = (f"{v * 1e6:.1f}us" if v is not None
                   else f"score={c.get('score'):.3f}")
            print(f"      runner-up {tuple(c['config'])}  {v_s}", file=out)
    if len(decisions) > limit:
        print(f"  … {len(decisions) - limit} more", file=out)


def report(payload: dict, top: int = 10, out=sys.stdout) -> None:
    events = payload.get("traceEvents", [])
    agg = _build_tree(events)
    _print_tree(agg, out)
    _print_top_self(agg, top, out)
    _print_counters(payload.get("repro_metrics", {}), out)
    _print_decisions(payload.get("repro_decisions", []), out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Summarize a repro_torch.obs Chrome-trace JSON")
    ap.add_argument("trace", help="path to a trace written by "
                    "obs.tracing(path) / --trace")
    ap.add_argument("--top", type=int, default=10,
                    help="rows in the self-time ranking")
    args = ap.parse_args(argv)
    try:
        with open(args.trace) as fh:
            payload = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        print(f"cannot read trace {args.trace!r}: {e}", file=sys.stderr)
        return 1
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        print(f"{args.trace!r} is not a Chrome-trace export "
              "(no traceEvents key)", file=sys.stderr)
        return 1
    report(payload, top=args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
