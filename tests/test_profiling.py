"""Profiling capability: trace capture + reduction to device metrics.

The reduction keys on the names a GPU trace uses (a "/device:GPU:<n>"
process with "Stream #..." threads). The fixture below is a small trace in
that shape; on the CPU test backend a real capture has no such tracks, and
the reduction must say so instead of reporting a device time of 0.
"""

import glob

import jax
import jax.numpy as jnp
import pytest

from raytracingengine.utils.profiling import (
    TraceReport,
    parse_trace_events,
    profile_step,
)


def _meta(kind, pid, name, tid=None):
    e = {"ph": "M", "name": kind, "pid": pid, "args": {"name": name}}
    if tid is not None:
        e["tid"] = tid
    return e


def _x(pid, tid, name, ts, dur):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": ts, "dur": dur}


GPU_TRACE = [
    _meta("process_name", 1, "/device:GPU:0"),
    _meta("thread_name", 1, "Stream #13(MemcpyD2D,Compute,MemcpyD2H)", tid=13),
    _meta("thread_name", 1, "Stream #14(Compute)", tid=14),
    _meta("process_name", 701, "/host:CPU"),
    _meta("thread_name", 701, "python", tid=5),
    _x(1, 13, "closest_hit", 100.0, 400.0),
    _x(1, 13, "input_concatenate_fusion_2", 600.0, 100.0),
    _x(1, 14, "closest_hit", 300.0, 400.0),  # overlaps the first on stream 13
    _x(701, 5, "$api.py block_until_ready", 0.0, 5000.0),
]


def test_profile_step_captures_and_parses(tmp_path):
    f = jax.jit(lambda x: jnp.sum(x * x + 1.0))
    x = jnp.arange(4096, dtype=jnp.float32)
    # The CPU backend writes a trace, but with no GPU tracks in it.
    with pytest.raises(RuntimeError, match="no GPU kernel events"):
        profile_step(lambda: f(x), trace_dir=str(tmp_path))
    assert glob.glob(str(tmp_path) + "/**/*.trace.json.gz", recursive=True)


def test_gpu_trace_fixture_op_times():
    op_ms, _ = parse_trace_events(GPU_TRACE)
    assert op_ms == pytest.approx(
        {"closest_hit": 0.8, "input_concatenate_fusion_2": 0.1})


def test_gpu_trace_fixture_busy_is_interval_union():
    _, busy = parse_trace_events(GPU_TRACE)
    assert busy == pytest.approx(0.6)  # [100, 700] us: overlap counted once


def test_host_only_trace_raises():
    host = [e for e in GPU_TRACE if e.get("pid") != 1]
    with pytest.raises(RuntimeError, match="/host:CPU"):
        parse_trace_events(host)


def test_report_idle_share():
    rep = TraceReport(wall_ms=2.0, device_busy_ms=0.5, op_ms={"k": 0.5},
                      trace_dir="")
    assert rep.idle_share == pytest.approx(0.75)
    assert "idle share 0.750" in rep.pretty()
