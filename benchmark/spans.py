"""What the readers of the program's spans share (``metrics/*.py`` with
``SOURCE = "program_span"`` that read ``serve.*`` or ``train.*``): the
spans ``coarse3d_tpu_torch/utils/profiling.py`` recorded in the traced
slice, their device time, and the slice's idle time put down to the span
the host was in.

The traced slice's idle time is every interval of its window
(``trace.py``: ``window_s``) that no device operation covers. The window
ends with its last event, the synchronise after the last device
operation, so it is taken to end at the last device operation's end; the
idle time found is then exactly ``window_s - busy_s``. Span and device
times are on one clock, the profiler's own (``time.time_ns()``).

A program without spans (one older than them) gives no spans, and each
reader then returns None. Run as a script, this runs one cell with its
traced slice, prints the result line as ``run.py --trace 1`` does and
then, for every span name, its host self, device and idle milliseconds a
batch or step:

    python3 benchmark/spans.py --workload <name> --seed <n> --seconds <s>
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def program_spans(ctx: dict) -> list[dict] | None:
    """The program's spans of this run's traced slice, or None."""
    if not ctx.get("trace"):
        return None
    try:
        from coarse3d_tpu_torch.utils.profiling import traced_spans
    except ImportError:
        return None
    return traced_spans() or None


def device_ms(ctx: dict, name: str) -> float | None:
    """Mean device milliseconds of the spans named ``name``."""
    found = [s["device_ms"] for s in program_spans(ctx) or ()
             if s["name"] == name]
    return sum(found) / len(found) if found else None


def _merge(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _minus(xs, ys) -> list[tuple[float, float]]:
    """The merged intervals ``xs`` less the merged intervals ``ys``."""
    out = []
    for a, b in xs:
        for c, d in ys:
            if d <= a or c >= b:
                continue
            if c > a:
                out.append((a, c))
            a = max(a, d)
            if a >= b:
                break
        if a < b:
            out.append((a, b))
    return out


def _length(xs, ys) -> float:
    """Length of the intersection of two merged interval lists."""
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += min(b, ys[k][1]) - max(a, ys[k][0])
            k += 1
    return total


def idle_intervals(trace: dict) -> tuple[list, float, float]:
    """The slice's idle intervals (seconds), and its window's start and
    end."""
    device = trace["device"]
    t1 = max(s + d for _, s, d in device)
    t0 = t1 - trace["window_s"]
    busy = _merge((s, s + d) for _, s, d in device)
    return _minus([(t0, t1)], busy), t0, t1


def _host(spans, name=None) -> list[tuple[float, float]]:
    return _merge((s["start_ns"] * 1e-9, s["end_ns"] * 1e-9) for s in spans
                  if name is None or s["name"] == name)


def idle_pct(ctx: dict, inside: str | None, outside: str | None = None
             ) -> float | None:
    """Percent of the traced slice in which no device operation ran while
    the host was inside a span named ``inside`` and not inside one named
    ``outside``; ``inside=None``: inside no span at all."""
    spans, trace = program_spans(ctx), ctx.get("trace")
    if not spans or not trace or not trace["device"] or (
            trace["window_s"] <= 0):
        return None
    idle, t0, t1 = idle_intervals(trace)
    if inside is None:
        region = _minus([(t0, t1)], _host(spans))
    else:
        region = _host(spans, inside)
        if outside is not None:
            region = _minus(region, _host(spans, outside))
    return 100.0 * _length(idle, region) / trace["window_s"]


def table(ctx: dict) -> list[dict]:
    """For every span name, in the order the names first opened: its
    host self time (its spans' time less that of their children), device
    time and idle time (the slice's idle time while it was the innermost
    span open), in milliseconds a root span (a batch or step); last,
    ``(outside)``: the idle time inside no span."""
    spans, trace = program_spans(ctx), ctx.get("trace")
    if not spans:
        return []
    roots = sum(s["parent"] is None for s in spans) or 1
    children: dict = {}
    for s in spans:
        children.setdefault(s["parent"], []).append(s)
    idle = None
    if trace and trace["device"] and trace["window_s"] > 0:
        idle, t0, t1 = idle_intervals(trace)
    rows: dict[str, dict] = {}
    for s in spans:
        own = _minus(_host([s]), _host(children.get(s["id"], [])))
        row = rows.setdefault(s["name"], {"span": s["name"], "count": 0,
                                          "host_self_ms": 0.0,
                                          "device_ms": 0.0, "idle_ms": 0.0})
        row["count"] += 1
        row["host_self_ms"] += 1e3 * sum(b - a for a, b in own) / roots
        row["device_ms"] += s["device_ms"] / roots
        if idle is not None:
            row["idle_ms"] += 1e3 * _length(idle, own) / roots
    out = list(rows.values())
    if idle is not None:
        outside = _minus([(t0, t1)], _host(spans))
        out.append({"span": "(outside)", "count": 0, "host_self_ms": 0.0,
                    "device_ms": 0.0,
                    "idle_ms": 1e3 * _length(idle, outside) / roots})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from benchmark import harness
    from benchmark import run as brun

    brun._environment()
    wl = harness.cell(harness.manifest(), args.workload)
    harness.device_check(wl["chips"])
    seen: dict = {}
    read_per_layer = harness.read_per_layer

    def keep(man, wl, ctx, root=ROOT):
        seen.update(ctx)
        return read_per_layer(man, wl, ctx, root)

    harness.read_per_layer = keep
    result = brun.run_cell(args.workload, args.seed, args.seconds, True)
    print(json.dumps(result), flush=True)
    window = seen["trace"]["window_s"] if seen.get("trace") else 0.0
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "window_s": window, "spans": table(seen)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
