"""What the per-layer readers share. A reader returns None when its run
has nothing for it to read (no trace, no span, no call), and the harness
then leaves the metric out of the line."""

from __future__ import annotations

import importlib

from benchmark import peaks


def op_roofline(run, op: str, work_name: str, span: str):
    """The op's least time over the device time of every activity launched
    inside its span, in %: the least time is the larger of its bytes at the
    memory rate and its operations at the bf16 peak, summed over the op's
    calls in the window."""
    tl = run.timeline
    calls = run.spans.calls.get(op) if run.spans is not None else None
    if tl is None or not calls or not tl.span_count(span):
        return None
    device = tl.device_s(span)
    if device <= 0:
        return None
    work = importlib.import_module(f"benchmark.work.{work_name}").work
    least = sum(peaks.least_seconds(*work(*c)[::-1]) for c in calls)
    return 100.0 * least / device


def per_batch_ms(run, seconds):
    n = run.stats.get("batches")
    if seconds is None or not n:
        return None
    return 1e3 * seconds / n


def mfu(run):
    """The model FLOPs of the work the traced window completed over the
    device's busy time in it and the bf16 peak, in %: the card's share of
    its peak while it runs, which the profiler's slowing of the host does
    not move (the host's share shows in ``idle_share``)."""
    tl = run.timeline
    flops, units = run.stats.get("model_flops"), run.stats.get("units")
    if tl is None or tl.busy_s <= 0 or not flops or not units:
        return None
    return 100.0 * flops * units / tl.busy_s / peaks.PEAK_FLOPS["bfloat16"]


def idle_share(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
