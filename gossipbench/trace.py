"""Reading a `torch.profiler` trace of the traced calls: the device's
operations, the host's operations, and the window the calls span.

`profile(fn)` runs `fn` under the profiler and returns a `Trace`.  Each
call of the window is marked by the harness with a `CALL` range, so the
window is the span from the first call's start to the last call's end,
in the trace's own clock.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

CALL = "gossipbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Trace:
    device: list    # (name, start us, end us, category) of each device op
    host: list      # (name, start us, end us) of each host operation
    window: tuple   # (start us, end us) of the traced calls

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy(self) -> list:
        """Merged intervals in which an operation ran on the device,
        clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi))
                       for _, s, e, _ in self.device if e > lo and s < hi)
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def device_time_s(self, match, cats=DEVICE_CATS) -> float:
        """Seconds of the device operations of a category in `cats` whose
        name `match` accepts."""
        return sum(e - s for name, s, e, cat in self.device
                   if cat in cats and match(name)) / 1e6

    def gaps(self) -> list:
        """(start, end) of each stretch of the window with nothing on the
        device."""
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing (the innermost host operation running at
        each gap's middle), each as [name, seconds], largest first."""
        ops: dict = {}
        for name, s, e, _ in self.device:
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
        host = sorted(self.host, key=lambda h: h[1])
        idle: dict = {}
        active, k = [], 0
        for s, e in self.gaps():   # in order of time: one sweep
            mid = 0.5 * (s + e)
            while k < len(host) and host[k][1] <= mid:
                active.append(host[k])
                k += 1
            active = [h for h in active if h[2] >= mid]
            name = (min(active, key=lambda h: h[2] - h[1])[0] if active
                    else "host: no torch op (python, numpy)")
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e6
        return {"device_ops": _top(ops, top), "idle_gaps": _top(idle, top)}


def _top(d: dict, k: int) -> list:
    return [[name[:160], sec] for name, sec in
            sorted(d.items(), key=lambda kv: -kv[1])[:k]]


def load(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, calls = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, span = ev.get("cat"), (float(ev["ts"]),
                                    float(ev["ts"]) + float(ev.get("dur", 0)))
        if cat in DEVICE_CATS:
            device.append((ev["name"], *span, cat))
        elif cat == "user_annotation" and ev["name"] == CALL:
            calls.append(span)
        elif cat in HOST_CATS:
            host.append((ev["name"], *span))
    if not calls:
        raise ValueError("the trace marks no call")
    return Trace(device, host, (min(s for s, _ in calls),
                                max(e for _, e in calls)))


def profile(torch, fn) -> Trace:
    """Run `fn` under `torch.profiler` (host and device activities) and
    read the trace back; the trace file lives in a temporary directory
    only while it is read."""
    from torch.profiler import ProfilerActivity, profile as _profile

    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return load(path)
