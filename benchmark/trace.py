"""The traced window: the profiler's timeline reduced to device busy time,
the device time of the kernels launched inside the benchmark's own spans,
and a breakdown of device operations and idle gaps.

A span is a ``torch.profiler.record_function`` range whose name starts with
``bench.``; ``spans.py`` puts them around the program's op entries. A
device activity (kernel, copy, set) belongs to a span when the host call
that launched it ran inside the span, on the same thread.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "bench."
BREAKDOWN_ENTRIES = 10
LABELLED_GAPS = 500        # the longest idle gaps named by the host's activity


def _kind(name: str) -> str:
    if name.startswith("Memcpy HtoD"):
        return "h2d"
    if name.startswith("Memcpy DtoH"):
        return "d2h"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "copy"
    return "kernel"


class Window:
    """Profiles the measured window when tracing is on."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.t0 = self.t1 = None

    def start(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        self.t1 = time.perf_counter()
        if self.prof is not None:
            self.prof.stop()

    def reduce(self) -> Optional["Timeline"]:
        if self.prof is None:
            return None
        return Timeline(self.prof.profiler.kineto_results.events(), self.t1 - self.t0)


class Timeline:
    def __init__(self, events, window_s: float):
        self.window_s = window_s
        launches: Dict[int, Tuple[int, int]] = {}       # CUPTI correlation -> (thread, ns)
        ops: Dict[int, Tuple[int, int]] = {}             # op id -> (thread, ns)
        host: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
        spans: Dict[str, Dict[int, List[Tuple[int, int]]]] = defaultdict(lambda: defaultdict(list))
        device = []
        for ev in events:
            name = ev.name()
            start, dur = ev.start_ns(), ev.duration_ns()
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if ev.is_user_annotation() or name.startswith(SPAN_PREFIX):
                    continue
                device.append((start, start + dur, name, ev.correlation_id(),
                               ev.linked_correlation_id()))
                continue
            tid = ev.start_thread_id()
            if name.startswith(SPAN_PREFIX):
                spans[name][tid].append((start, start + dur))
            elif name.startswith("cu"):
                launches[ev.correlation_id()] = (tid, start)
            else:
                ops[ev.correlation_id()] = (tid, start)
                host[tid].append((start, start + dur, name))
        self.device = []
        unlinked = 0
        for start, end, name, corr, linked in sorted(device):
            at = launches.get(corr) or ops.get(linked)
            if at is None:
                unlinked += 1
            self.device.append((start, end, name, _kind(name), at))
        self.unlinked = unlinked
        self.spans = {n: {t: sorted(v) for t, v in per.items()} for n, per in spans.items()}
        self.span_starts = {n: {t: [s for s, _ in v] for t, v in per.items()}
                            for n, per in self.spans.items()}
        self.host = {t: sorted(v) for t, v in host.items()}
        self.host_starts = {t: [s for s, _, _ in v] for t, v in self.host.items()}
        self.busy_intervals = self._merge([(s, e) for s, e, *_ in self.device])
        self.busy_s = sum(e - s for s, e in self.busy_intervals) / 1e9

    @staticmethod
    def _merge(intervals):
        out = []
        for s, e in sorted(intervals):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def span_count(self, name: str) -> int:
        return sum(len(v) for v in self.spans.get(name, {}).values())

    def _in_span(self, name: str, at) -> bool:
        if at is None:
            return False
        tid, t = at
        starts = self.span_starts.get(name, {}).get(tid)
        if not starts:
            return False
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and self.spans[name][tid][i][1] >= t

    def device_s(self, span: Optional[str] = None, kinds=("kernel", "h2d", "d2h", "copy")) -> float:
        """Seconds of device activity of ``kinds`` (launched inside ``span``)."""
        total = 0
        for start, end, _, kind, at in self.device:
            if kind in kinds and (span is None or self._in_span(span, at)):
                total += end - start
        return total / 1e9

    def _host_activity(self, at) -> str:
        if at is None:
            return "host: not linked"
        tid, t = at
        starts = self.host_starts.get(tid, [])
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and t - starts[i] < 10 ** 10:
            s, e, name = self.host[tid][i]
            if e >= t:
                return name
            i -= 1
        return "host: outside any op"

    def breakdown(self) -> dict:
        by_name: Dict[str, int] = defaultdict(int)
        for start, end, name, _, _ in self.device:
            by_name[name[:120]] += end - start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        gaps = []
        dev = self.device
        j = 0
        for (_, e0), (s1, _) in zip(self.busy_intervals, self.busy_intervals[1:]):
            while j < len(dev) and dev[j][0] < s1:
                j += 1
            nxt = dev[j] if j < len(dev) else None
            gaps.append((s1 - e0, e0, nxt[4] if nxt else None))
        gaps.sort(key=lambda g: -g[0])
        by_host: Dict[str, int] = defaultdict(int)
        for length, e0, at in gaps[:LABELLED_GAPS]:
            label = self._host_activity(None if at is None else (at[0], e0))
            by_host[label[:120]] += length
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        return {"device_ops": [[n, v / 1e9] for n, v in ops],
                "idle_gaps": [[n, v / 1e9] for n, v in idle]}
