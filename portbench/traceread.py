"""The traced run's profiler window, reduced to what the readers need.

``torch.profiler`` records the device's operations (kernels, copies and
sets, by name, with their start and end) and the host's (the ATen
operators and the CUDA runtime calls). :class:`Tracer` runs it over a
stretch of the run and hands back a :class:`TraceSummary`: the device's
busy time (the union of its operations' intervals), each kernel's device
time and count by name, the operations that took most time, and the
longest idle gaps by the host operation that covered them.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import numpy as np

#: idle stretches shorter than this are not attributed (launch spacing)
GAP_FLOOR_NS = 20_000
#: the longest gaps attributed to a host operation
GAPS_ATTRIBUTED = 4000


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


class TraceSummary:
    def __init__(self, window_s: float, device_ops, host_ops):
        self.window_s = window_s
        # (name, start_ns, end_ns), sorted by start
        self.device_ops = sorted(device_ops, key=lambda e: e[1])
        self.host_ops = sorted(host_ops, key=lambda e: e[1])
        self._union = self._merge([(s, e) for _, s, e in self.device_ops])

    @staticmethod
    def _merge(intervals):
        out: list[list[int]] = []
        for s, e in intervals:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._union) / 1e9

    def kernel(self, part: str) -> tuple[float, int]:
        """(device seconds, count) of the operations whose name holds ``part``."""
        total, count = 0, 0
        for name, s, e in self.device_ops:
            if part in name:
                total += e - s
                count += 1
        return total / 1e9, count

    def top_device_ops(self, k: int = 10) -> list[list]:
        by = defaultdict(int)
        for name, s, e in self.device_ops:
            by[name] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:200], ns / 1e9] for name, ns in top]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The idle stretches between the device's operations, longest
        first, summed by the innermost host operation that covers each
        one's middle ("host code" where none does)."""
        u = self._union
        gaps = [(u[i + 1][0] - u[i][1], u[i][1], u[i + 1][0]) for i in range(len(u) - 1)]
        gaps = sorted((g for g in gaps if g[0] >= GAP_FLOOR_NS), reverse=True)
        gaps = gaps[:GAPS_ATTRIBUTED]
        starts = [h[1] for h in self.host_ops]
        by = defaultdict(int)
        for length, g0, g1 in gaps:
            mid = (g0 + g1) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name, best = "host code", None
            # the innermost covering event starts last among those that cover
            for j in range(i, max(i - 256, -1), -1):
                hn, hs, he = self.host_ops[j]
                if he >= mid:
                    name, best = hn, j
                    break
            by[name if best is not None else "host code"] += length
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:200], ns / 1e9] for name, ns in top]


class Tracer:
    """``torch.profiler`` over a stretch of the run: the host's operators
    and, on a card, the device's."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        self.prof = None
        self.t0 = 0.0

    def _activities(self):
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def warm(self) -> None:
        """One short capture, so the profiler's own start-up (seconds, the
        first time in a process) falls in set-up, not in the window."""
        import torch
        from torch.profiler import profile

        with profile(activities=self._activities()):
            x = torch.ones(1024, device=self.device)
            (x * 2).sum().item()

    def start(self) -> None:
        from torch.profiler import profile

        self.prof = profile(activities=self._activities())
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> TraceSummary:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        device_ops, host_ops = [], []
        for ev in self.prof.profiler.kineto_results.events():
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if _is_device(ev):
                device_ops.append((ev.name(), s, e))
            else:
                host_ops.append((ev.name(), s, e))
        self.prof = None
        return TraceSummary(window, device_ops, host_ops)


def quantile(values, q: float) -> float | None:
    """The q-quantile of ``values`` (linear between order statistics)."""
    if len(values) == 0:
        return None
    return float(np.quantile(np.asarray(values, np.float64), q))
