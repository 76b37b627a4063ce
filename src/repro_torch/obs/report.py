"""Run-report CLI: summarize a telemetry JSONL event stream.

    python -m repro_torch.obs.report run.jsonl

Counterpart of ``repro/obs/report.py``.  Renders, from any stream the
schema accepts (live tail of a running simulation or a finished run):

* the run header (kind, engine/scheme, n, steps, total wall);
* a phase table from the ``span`` events — where wall-clock went;
* chunk throughput (overall steps/sec, per-chunk min/median/max);
* a step-phase table from the chunks' ``phases`` fields (device-stream
  time of each phase a step, :mod:`repro_torch.obs.phases`), and the
  host's enqueue and drain time a step, when the run was marked;
* the final cumulative counters (spikes, drops, health sentinels,
  tile-skip stats — whatever the carry carried);
* the compile-cache table (per-signature records and hit/miss totals;
  the port runs eagerly, so its trace and compile times are 0 and its
  FLOPs and bytes unknown);
* resilience events (health breaches, checkpoints, restarts,
  escalations), when any occurred;
* serving traffic (``serve_*`` events): terminal-status counts,
  admissions and batches (mean lanes a batch), completed-request
  latency p50/p99, shed/retry/quarantine incidents.

Everything is plain text, zero dependencies; exit code 1 when the
stream contains no events.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def load_events(path: str) -> list[dict]:
    events = []
    for line in Path(path).read_text().splitlines():
        if line.strip():
            events.append(json.loads(line))
    return events


def _by_type(events, type_: str) -> list[dict]:
    return [e for e in events if e.get("type") == type_]


def _fmt_s(v) -> str:
    return "-" if v is None else f"{v:.3f}s"


def _table(rows: list[list[str]], header: list[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    def line(r):
        return "  ".join(str(c).ljust(w) for c, w in zip(r, widths)).rstrip()
    return "\n".join([line(header), line(["-" * w for w in widths])]
                     + [line(r) for r in rows])


def _median(xs: list[float]) -> float:
    xs = sorted(xs)
    m = len(xs) // 2
    return xs[m] if len(xs) % 2 else 0.5 * (xs[m - 1] + xs[m])


def _phase_table(chunks: list[dict]) -> list[str]:
    """Step phases summed over the marked chunks: seconds, ms a step and
    share of the marked stream time; then the host's time a step to enqueue
    the steps (the chunk's wall time less its drain) and in the drain."""
    marked = [c for c in chunks if c.get("phases")]
    if not marked:
        return []
    steps = sum(c["steps"] for c in marked)
    totals: dict[str, float] = {}
    for c in marked:
        for name, sec in c["phases"].items():
            totals[name] = totals.get(name, 0.0) + sec
    whole = sum(totals.values()) or 1.0
    rows = [[name, f"{sec:.3f}s", f"{1e3 * sec / steps:.4f}",
             f"{100 * sec / whole:.1f}%"]
            for name, sec in sorted(totals.items(), key=lambda kv: -kv[1])]
    wall = sum(c["wall_s"] for c in marked)
    drain = sum(c.get("drain_s", 0.0) for c in marked)
    return ["", f"step phases (device stream, {steps} steps over "
            f"{len(marked)} marked chunk(s)):",
            _table(rows, ["phase", "total", "ms/step", "share"]),
            f"host: enqueue {1e3 * (wall - drain) / steps:.4f} ms/step, "
            f"drain {1e3 * drain / steps:.4f} ms/step"]


def summarize(events: list[dict]) -> str:
    out: list[str] = []

    # -- run header --------------------------------------------------------
    starts, ends = _by_type(events, "run_start"), _by_type(events, "run_end")
    for s in starts:
        what = s.get("engine") or s.get("scheme") or "?"
        out.append(f"run: {s.get('kind', '?')} ({what}) n={s.get('n', '?')} "
                   f"t_steps={s.get('t_steps', '?')}"
                   + (f" chunk_steps={s['chunk_steps']}"
                      if s.get("chunk_steps") else "")
                   + (" [fixed-point]" if s.get("fixed_point") else ""))
    for e in ends:
        out.append(f"completed: {e.get('steps', '?')} steps in "
                   f"{_fmt_s(e.get('wall_s'))}")
    if not starts and not ends:
        out.append(f"(no run_start/run_end — partial stream of "
                   f"{len(events)} events)")

    # -- phases ------------------------------------------------------------
    spans: dict[str, dict] = {}
    for e in _by_type(events, "span"):
        p = spans.setdefault(e["name"], {"count": 0, "total": 0.0,
                                         "max": 0.0})
        p["count"] += 1
        p["total"] += e["wall_s"]
        p["max"] = max(p["max"], e["wall_s"])
    if spans:
        out.append("")
        out.append("phases (spans):")
        rows = [[name, p["count"], f"{p['total']:.3f}s",
                 f"{p['total'] / p['count']:.4f}s", f"{p['max']:.4f}s"]
                for name, p in sorted(spans.items(),
                                      key=lambda kv: -kv[1]["total"])]
        out.append(_table(rows, ["phase", "count", "total", "mean", "max"]))

    # -- chunk throughput --------------------------------------------------
    chunks = _by_type(events, "chunk")
    if chunks:
        steps = sum(c["steps"] for c in chunks)
        wall = sum(c["wall_s"] for c in chunks)
        rates = [c["steps_per_s"] for c in chunks]
        out.append("")
        out.append(f"throughput: {steps} steps / {wall:.3f}s over "
                   f"{len(chunks)} chunk(s) = "
                   f"{steps / wall if wall else float('inf'):.1f} steps/sec "
                   f"(per-chunk min {min(rates):.1f} / median "
                   f"{_median(rates):.1f} / max {max(rates):.1f})")
        final = chunks[-1].get("counters", {})
        if final:
            out.append("counters (cumulative at last chunk): " + "  ".join(
                f"{k}={v}" for k, v in sorted(final.items())))
        out.extend(_phase_table(chunks))
    elif ends and ends[-1].get("counters"):
        out.append("counters: " + "  ".join(
            f"{k}={v}" for k, v in sorted(ends[-1]["counters"].items())))

    # -- compile cache -----------------------------------------------------
    compiles = _by_type(events, "compile")
    metrics = ends[-1].get("metrics", {}) if ends else {}
    hits = metrics.get("compile_cache.hits")
    misses = metrics.get("compile_cache.misses")
    if compiles or hits is not None or misses is not None:
        out.append("")
        hm = (f" (hits={int(hits or 0)} misses={int(misses or 0)})"
              if hits is not None or misses is not None else "")
        out.append(f"compile cache: {len(compiles)} compile(s){hm}")
        if compiles:
            rows = [[c["fn"], c["signature"][:12],
                     f"{c['trace_s']:.3f}s", f"{c['compile_s']:.3f}s",
                     "-" if c.get("flops") is None
                     else f"{c['flops']:.3g}",
                     "-" if c.get("bytes_accessed") is None
                     else f"{c['bytes_accessed']:.3g}",
                     "fallback" if c.get("fallback") else ""]
                    for c in compiles]
            out.append(_table(rows, ["fn", "signature", "trace", "compile",
                                     "flops", "bytes", ""]))

    # -- serving -----------------------------------------------------------
    req_ends = _by_type(events, "serve_request_end")
    if req_ends:
        out.append("")
        statuses: dict[str, int] = {}
        for e in req_ends:
            statuses[e["status"]] = statuses.get(e["status"], 0) + 1
        out.append("serving: " + "  ".join(
            f"{k}={v}" for k, v in sorted(statuses.items())))
        batches = [e["size"] for e in _by_type(events, "serve_batch")]
        out.append(f"admitted {len(_by_type(events, 'serve_admit'))}, "
                   f"{len(batches)} batch(es)"
                   + (f", mean {sum(batches) / len(batches):.2f} lanes"
                      if batches else ""))
        lat = sorted(e["wall_s"] for e in req_ends
                     if e["status"] == "completed")
        if lat:
            p = lambda q: lat[min(len(lat) - 1,    # noqa: E731
                                  int(q * (len(lat) - 1) + 0.5))]
            out.append(f"request latency: p50={p(0.5):.3f}s "
                       f"p99={p(0.99):.3f}s over {len(lat)} completed")
        reasons: dict[str, int] = {}
        for e in req_ends:
            if e.get("reason"):
                reasons[e["reason"]] = reasons.get(e["reason"], 0) + 1
        if reasons:
            out.append("terminal reasons: " + "  ".join(
                f"{k}={v}" for k, v in sorted(reasons.items())))
        serve_incidents = [e for e in events if e.get("type") in
                           ("serve_shed", "serve_retry", "serve_quarantine",
                            "serve_deadline", "serve_degrade")]
        for e in serve_incidents:
            kind = e["type"].removeprefix("serve_")
            who = (f"rid={e['rid']}" if "rid" in e
                   else f"rids={e.get('rids')}")
            detail = e.get("reason") or e.get("error") or e.get("what") or ""
            out.append(f"  t={e['t']:.3f}s {kind} {who}"
                       + (f" ({detail})" if detail else "")
                       + (f" backoff={e['backoff_s']:.3f}s"
                          if "backoff_s" in e else ""))

    # -- resilience events -------------------------------------------------
    ckpts = _by_type(events, "checkpoint")
    if ckpts:
        out.append("")
        out.append(f"checkpoints: {len(ckpts)} "
                   f"(steps {', '.join(str(c['step']) for c in ckpts)})")
    incidents = [e for e in events
                 if e.get("type") in ("health", "restart", "escalation")]
    if incidents:
        out.append("")
        out.append("incidents:")
        for e in incidents:
            kind = e["type"]
            if kind == "health":
                out.append(f"  t={e['t']:.3f}s health breach "
                           f"{e['kind']}={e['value']} at step {e['step']} "
                           f"(threshold {e.get('threshold')})")
            else:
                out.append(f"  t={e['t']:.3f}s {kind} #{e['attempt']} -> "
                           f"resume from {e.get('resume_step')}"
                           + (f" ({e['error']})" if e.get("error") else ""))
    return "\n".join(out)


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        sys.exit("usage: python -m repro_torch.obs.report run.jsonl")
    events = load_events(argv[0])
    if not events:
        print(f"{argv[0]}: no events")
        return 1
    print(summarize(events))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
