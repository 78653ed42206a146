"""Spans, call records and the reduction of a profiler trace.

``Tracer`` is what a driver talks to: ``span(name)`` opens a
``torch.profiler.record_function`` range while the profiler runs and costs
nothing otherwise; ``record(name, item)`` keeps the shapes of a call into
the port for the work counts; ``start()`` and ``stop()`` bracket the traced
slice of the window, which a ``traced_window`` span marks.

``reduce_trace`` reads the slice's Chrome trace (the profiler's own
export): device operations (kernels, copies, fills) are tied to the host
launch that the trace correlates them with, and through it to every
harness span open on the host at that moment.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_NULL = contextlib.nullcontext()


class Tracer:
    def __init__(self, enabled: bool, span_names=()):
        self.enabled = enabled
        self.span_names = set(span_names) | {"traced_window"}
        self.on = False
        self.calls = defaultdict(list)
        self.prof = None
        self.summary = None
        self._window = None

    def span(self, name):
        return torch.profiler.record_function(name) if self.on else _NULL

    def record(self, name, item):
        if self.on:
            self.calls[name].append(item)

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def prime(self, device):
        """One empty profiling session, so that the profiler's first start
        (CUPTI's set-up, seconds) falls in set-up and not in the window."""
        if not self.enabled:
            return
        with self._profile():
            torch.zeros(1, device=device).add_(1)
            if device.type == "cuda":
                torch.cuda.synchronize()

    def start(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof = self._profile()
        self.prof.start()
        self.on = True
        self._window = torch.profiler.record_function("traced_window")
        self._window.__enter__()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.on = False
        t0 = time.perf_counter()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        self.summary = reduce_trace(events, self.span_names)
        self.summary["reduce_s"] = time.perf_counter() - t0


def kernel_name(name: str) -> str:
    """A device operation's name without its argument list or return type:
    ``void (anonymous namespace)::segsum_short<3>(float const*, ...)`` ->
    ``segsum_short<3>``."""
    short = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return short.split("(")[0].strip()[:120]


def idle_percent(summary):
    """The traced window's idle share of the device, in percent."""
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def union_seconds(intervals):
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _ancestors(host_events, spans):
    """For each (ts, key) host event, the names of the spans (start, end,
    name), properly nested on one thread, that contain ts: {key: tuple}."""
    marks = sorted([(s, 0, e, n) for s, e, n in spans] + [(ts, 1, None, key)
                                                           for ts, key in host_events],
                   key=lambda m: (m[0], m[1]))
    stack, out = [], {}
    for t, kind, end, item in marks:
        while stack and stack[-1][0] <= t:
            stack.pop()
        if kind == 0:
            stack.append((end, item))
        else:
            out[item] = tuple(n for _, n in stack)
    return out


def reduce_trace(events, span_names):
    """Summary of one traced slice (times in seconds): ``window_s``,
    ``busy_s`` (the union of device operations inside the window),
    ``device_s_in`` ({span: device seconds of operations launched inside
    it}), ``span_counts``, ``device_ops`` (the ten operations that took the
    most device time, by name), ``idle_gaps`` (idle device time inside the
    window, by the innermost span and host operation open when each gap
    began; the ten largest), ``device_ops_total`` and ``unlinked`` (device
    operations the trace ties to no host launch)."""
    spans, launches, device, cpu_ops = [], {}, [], []
    main = [ev.get("tid") for ev in events
            if ev.get("cat") == "user_annotation" and ev.get("name") == "traced_window"]
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat == "user_annotation" and ev["name"] in span_names and ev.get("tid") in main:
            spans.append((ts, ts + dur, ev["name"]))
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, ev["name"], ev.get("args", {}).get("correlation")))
        elif cat == "cpu_op" and ev.get("tid") in main:
            cpu_ops.append((ts, ts + dur, ev["name"]))
    windows = [s for s in spans if s[2] == "traced_window"]
    if not windows:
        raise RuntimeError("the trace holds no traced_window span")
    w0, w1 = windows[0][0], windows[0][1]
    anc = _ancestors([(ts, c) for c, ts in launches.items()], spans)
    device_s_in = defaultdict(float)
    by_name = defaultdict(float)
    inside, unlinked = [], 0
    for s, e, name, corr in device:
        if e <= w0 or s >= w1:
            continue
        inside.append((max(s, w0), min(e, w1)))
        by_name[kernel_name(name)] += (e - s) * 1e-6
        names = anc.get(corr)
        if names is None:
            unlinked += 1
            continue
        for n in set(names):
            device_s_in[n] += (e - s) * 1e-6
    busy_us = union_seconds(inside)
    span_counts = defaultdict(int)
    for s, e, n in spans:
        span_counts[n] += 1
    idle = _idle_by_host(inside, w0, w1, spans, cpu_ops)
    return dict(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                device_s_in=dict(device_s_in), span_counts=dict(span_counts),
                device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
                idle_gaps=idle[:10], device_ops_total=len(inside), unlinked=unlinked)


def _idle_by_host(inside, w0, w1, spans, cpu_ops):
    """[(label, seconds)] of the window's idle device time, largest first,
    each gap labelled by the innermost harness span and host operation open
    when it began."""
    gaps, end = [], w0
    for s, e in sorted(inside):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if w1 > end:
        gaps.append((end, w1))
    keys = [(s, i) for i, (s, _) in enumerate(gaps)]
    in_span = _ancestors(keys, spans)
    in_op = _ancestors(keys, cpu_ops)
    by_label = defaultdict(float)
    for i, (s, e) in enumerate(gaps):
        span = (in_span.get(i) or ("none",))[-1]
        ops = in_op.get(i)
        by_label[f"{span}/{ops[-1]}" if ops else span] += (e - s) * 1e-6
    return sorted(by_label.items(), key=lambda kv: -kv[1])
