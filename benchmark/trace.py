"""The traced slice of a ``--trace 1`` run: torch.profiler over a fixed
number of batches or steps right after the measured window, reduced in
memory (nothing is written to disk) to what the per-layer readers and the
result's ``breakdown`` need.

On the card only the CUDA activity is traced: its kernels, copies and
fills, and the CUDA runtime calls that launched them. Host operators are
not recorded, since recording each of them slows a training step's host
work by a fifth and would make the slice measure the profiler. Without a
card (the CPU tests) the host operators stand in.

- ``device``: every operation that ran on the card as (name, start s,
  duration s) from the trace's own clock;
- ``busy_s``: the union of those intervals; ``window_s``: from the first
  host event of the slice (a runtime call; without one, the first device
  operation) to the end of its last event;
- ``device_ops``: the ten names that took most device time;
- ``idle_gaps``: the ten longest intervals with nothing on the card,
  each named after the innermost runtime call running at its middle, or
  ``host: python`` where the host was between calls;
- ``wall_s``: the slice's length by the host's clock, from the start of
  its first batch or step to the end of the synchronise after its last.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict

_TEMPLATE = re.compile(r"<.*")


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise,
    template arguments and parameter list."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return _TEMPLATE.sub("", name.split("(")[0]).strip().split("::")[-1]


class Tracer:
    """Open with :meth:`start`, close with :meth:`stop` after a
    synchronise; :meth:`summary` then reduces the events."""

    def __init__(self):
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        import torch

        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        from torch.autograd import DeviceType

        events = self.prof.profiler.kineto_results.events()
        device, host = [], []
        for e in events:
            rec = (e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9)
            if e.device_type() == DeviceType.CUDA:
                device.append(rec)
            elif rec[2] > 0:
                host.append(rec)
        if not device:
            return {"device": device, "busy_s": 0.0, "window_s": 0.0,
                    "device_ops": [], "idle_gaps": [], "wall_s": self.wall_s}
        t0 = min(s for _, s, _ in host or device)
        t1 = max(s + d for _, s, d in device + host)
        busy, gaps, cur_s, cur_e = 0.0, [], None, None
        for _, s, d in sorted(device, key=lambda r: r[1]):
            e = s + d
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                else:
                    gaps.append((t0, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        gaps.append((cur_e, t1))
        by_name = defaultdict(float)
        for name, _, d in device:
            by_name[short_name(name)] += d
        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        top_gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        named = []
        for a, b in top_gaps:
            mid = (a + b) / 2
            inside = [(d, n) for n, s, d in host if s <= mid <= s + d]
            label = min(inside)[1] if inside else "python"
            named.append([f"host: {label}", b - a])
        return {"device": device, "busy_s": busy, "window_s": t1 - t0,
                "device_ops": [[n, v] for n, v in top_ops],
                "idle_gaps": named, "wall_s": self.wall_s}


def kernel_time(summary: dict, names: tuple[str, ...], count_name: str
                ) -> tuple[float, int]:
    """Device seconds of the kernels whose short names are in ``names``,
    and the number of launches of the entry, counted by ``count_name``."""
    total, launches = 0.0, 0
    for name, _, d in summary.get("device", ()):
        short = short_name(name)
        if short in names:
            total += d
            if short == count_name:
                launches += 1
    return total, launches
