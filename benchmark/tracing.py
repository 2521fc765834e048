"""The traced run's reading of ``torch.profiler``: the device's operations
in the measured window, by layer, its busy time (the union of the device
intervals: kernels, copies, memsets) and the breakdown the result line
carries.

The profiler's Chrome trace is written into a temporary directory under
``TMPDIR``, read and deleted. The window is the span of the harness's
``benchmark.window`` annotation.
"""

from __future__ import annotations

import json
import re
import shutil
import tempfile
from pathlib import Path

import numpy as np

WINDOW = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
_GAPS_NAMED = 256  # the longest idle gaps attributed to a host activity
_TOP = 10


def merged(intervals):
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


class Trace:
    """Device and host events of one window, from a Chrome trace's events."""

    def __init__(self, events, layer_map):
        win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
        if not win:
            raise RuntimeError("the trace holds no window annotation")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.window_us = self.t1 - self.t0
        self.device = []  # (name, cat, start, end, bytes)
        self.host = []  # (name, start, end)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = float(e["ts"])
            t = s + float(e["dur"])
            if t < self.t0 or s > self.t1:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append((e["name"], cat, max(s, self.t0), min(t, self.t1),
                                    float(e.get("args", {}).get("bytes", 0) or 0)))
            elif cat in HOST_CATS:
                self.host.append((e["name"], s, t))
        patterns = [(re.compile(p), layer) for p, layer in layer_map["kernels"]]
        self._other, self._copies = layer_map["other"], layer_map["copies"]

        def layer_of(name, cat):
            if cat != "kernel":
                return self._copies if cat == "gpu_memcpy" else None
            return next((layer for p, layer in patterns if p.search(name)), self._other)

        self.layers = [layer_of(name, cat) for name, cat, *_ in self.device]
        self.busy_us = union_us([(s, t) for _, _, s, t, _ in self.device])

    def layer_us(self, layer):
        """Device time of the layer's operations in the window."""
        return sum(t - s for (_, _, s, t, _), lay in zip(self.device, self.layers)
                   if lay == layer)

    def memcpy(self):
        """(bytes, microseconds) of the host-device copies in the window."""
        copies = [(b, t - s) for name, cat, s, t, b in self.device
                  if cat == "gpu_memcpy" and ("HtoD" in name or "DtoH" in name)]
        return sum(b for b, _ in copies), sum(us for _, us in copies)

    def breakdown(self):
        """The device operations that took most time, and the idle gaps by
        what the host was doing (the shortest host event across the gap's
        middle), each at most ten ``[name, seconds]``."""
        per_name = {}
        for name, _, s, t, _ in self.device:
            per_name[name[:120]] = per_name.get(name[:120], 0.0) + (t - s) / 1e6
        ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:_TOP]

        busy = merged([(s, t) for _, _, s, t, _ in self.device])
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        by_host = {}
        if self.host:
            names = [h[0] for h in self.host]
            hs = np.array([h[1] for h in self.host])
            he = np.array([h[2] for h in self.host])
            for s, t in gaps[:_GAPS_NAMED]:
                mid = 0.5 * (s + t)
                inside = np.nonzero((hs <= mid) & (he >= mid))[0]
                name = "host: no traced activity" if inside.size == 0 else \
                    names[inside[np.argmin(he[inside] - hs[inside])]][:120]
                by_host[name] = by_host.get(name, 0.0) + (t - s) / 1e6
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:_TOP]
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in idle]}


def traced(profile_fn):
    """Run ``profile_fn(prof)`` under ``torch.profiler`` (host and CUDA
    activity) and return the trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tmp = Path(tempfile.mkdtemp(prefix="benchmark_trace_"))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profile_fn()
            torch.cuda.synchronize()
        path = tmp / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
