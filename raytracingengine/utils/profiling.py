"""Device profiling as a framework capability.

The reference's entire observability story is one chrono timer around
RenderImage (/root/reference/RaytracingEngine/RaytracingEngine.cpp:292-299).
Here: capture a `jax.profiler` trace of any step function and reduce it to
device time per kernel and the device's busy time.

    from raytracingengine.utils.profiling import profile_step
    report = profile_step(lambda: train_step(params))
    print(report.pretty())   # device ms by kernel, busy, idle share

In a GPU trace the device is a process named "/device:GPU:<n>" and its
kernels are complete ("X") events on threads named "Stream #<id>(...)";
an event's name is the XLA fusion or the Pallas kernel's name (e.g.
"closest_hit"). A trace without such events is an error, not a device
time of 0.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import gzip
import json
import os
import tempfile
import time

import jax

DEVICE_PROCESS_PREFIX = "/device:GPU:"
DEVICE_THREAD_PREFIX = "Stream #"


@dataclasses.dataclass
class TraceReport:
    wall_ms: float
    device_busy_ms: float            # union of kernel intervals, all devices
    op_ms: dict[str, float]          # kernel name -> summed device ms
    trace_dir: str

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.device_busy_ms / self.wall_ms)

    def top_ops(self, n: int = 10) -> list[tuple[str, float]]:
        return sorted(self.op_ms.items(), key=lambda kv: -kv[1])[:n]

    def pretty(self, n: int = 10) -> str:
        lines = [
            f"wall {self.wall_ms:.3f} ms | device busy {self.device_busy_ms:.3f} ms "
            f"| idle share {self.idle_share:.3f}"
        ]
        for name, ms in self.top_ops(n):
            lines.append(f"  {ms:9.3f} ms  {name[:100]}")
        return "\n".join(lines)


def _union_ms(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total / 1e3  # trace stores microseconds


def parse_trace_events(events: list[dict]) -> tuple[dict, float]:
    """Chrome-trace events -> (kernel name -> device ms, busy ms)."""
    pid_name, tid_name = {}, {}
    for e in events:
        if e.get("ph") != "M":
            continue
        if e.get("name") == "process_name":
            pid_name[e["pid"]] = e["args"]["name"]
        elif e.get("name") == "thread_name":
            tid_name[(e["pid"], e.get("tid"))] = e["args"]["name"]
    devices = {p for p, n in pid_name.items() if n.startswith(DEVICE_PROCESS_PREFIX)}
    op_ms: dict = collections.defaultdict(float)
    intervals = []
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in devices:
            continue
        if not tid_name.get((e["pid"], e.get("tid")), "").startswith(
            DEVICE_THREAD_PREFIX
        ):
            continue
        dur = float(e.get("dur", 0.0))
        op_ms[e["name"]] += dur / 1e3
        intervals.append((float(e["ts"]), float(e["ts"]) + dur))
    if not intervals:
        raise RuntimeError(
            "no GPU kernel events in the trace: expected a process named "
            f"'{DEVICE_PROCESS_PREFIX}<n>' with '{DEVICE_THREAD_PREFIX}' threads "
            f"(processes found: {sorted(pid_name.values())})"
        )
    return dict(op_ms), _union_ms(intervals)


def parse_trace_dir(trace_dir: str) -> tuple[dict, float]:
    """-> (kernel name -> device ms, busy ms) from the newest trace under dir."""
    cands = sorted(glob.glob(trace_dir + "/**/*.trace.json.gz", recursive=True))
    if not cands:
        raise RuntimeError(f"no *.trace.json.gz under {trace_dir}")
    with gzip.open(cands[-1], "rt") as f:
        return parse_trace_events(json.load(f)["traceEvents"])


def profile_step(fn, trace_dir: str | None = None, warmup: int = 1) -> TraceReport:
    """Run `fn()` under a device trace -> TraceReport.

    `fn` should be a nullary closure over jitted work (compile outside or
    accept the first-call compile in `warmup`).
    """
    for _ in range(max(warmup, 0)):
        jax.block_until_ready(fn())
    if trace_dir is None:
        trace_dir = tempfile.mkdtemp(prefix="rte_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    with jax.profiler.trace(trace_dir, create_perfetto_trace=True):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        wall_ms = (time.perf_counter() - t0) * 1e3
    op_ms, busy_ms = parse_trace_dir(trace_dir)
    return TraceReport(
        wall_ms=wall_ms, device_busy_ms=busy_ms, op_ms=op_ms, trace_dir=trace_dir
    )
