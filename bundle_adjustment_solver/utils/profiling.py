"""Device-clock numbers from JAX profiler traces.

A trace written by `jax.profiler.trace(dir)` is read back with
`jax.profiler.ProfileData` (no protobuf dependency). On a GPU each device
is a plane named ``/device:GPU:<n>``; its stream lines hold one event per
kernel with a nanosecond start and duration. XLA replays a program's kernels
as CUDA graphs ("command buffers"), whose events carry only the module; a
program compiled by `compile_per_op` launches each op on its own, and each
event's `tf_op` stat then holds the op-name path, which includes every
`jax.named_scope` the op was traced under. The point-major operators run
under stable scopes (`pm_assemble`, `pm_matvec`, `pm_cost`,
ops/point_major.py), so the reductions below find them by name.

Every reduction raises `RuntimeError` when the trace holds no GPU kernel
events: a device number is never silently replaced by nothing.
"""

from __future__ import annotations

import collections
import glob
import os
import shutil
import tempfile
import time
from typing import NamedTuple

import jax

GPU_PLANE_PREFIX = "/device:GPU:"
# Compiler options of a program whose trace names each op (no CUDA graphs).
PER_OP_EVENTS = {"xla_gpu_enable_command_buffer": ""}
# Each point-major operator's named scope and the jit function it runs in:
# XLA labels a fused kernel with the name path of one of its ops, which may
# carry the function but not the scope.
PM_SCOPES = {
    "pm_assemble": "jit(assemble_pm_tbl)",
    "pm_matvec": "jit(matvec_corr_pm)",
    "pm_cost": "jit(cost_pm_tbl)",
}
# Lines that a trace may derive from the kernel streams; they would count
# the same device time twice.
_DERIVED_LINES = ("XLA Modules", "XLA Ops", "Steps", "Framework Ops",
                  "Framework Name Scope", "Source code")


def load_profile(trace_dir: str):
    """The newest `ProfileData` written under `trace_dir`."""
    paths = sorted(
        glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                               "*.xplane.pb"))
    )
    if not paths:
        raise RuntimeError(f"no profiler trace under {trace_dir}")
    return jax.profiler.ProfileData.from_file(paths[-1])


class DeviceEvent(NamedTuple):
    """One kernel on a device plane; `text` joins the event name and its
    string stats (HLO op, op-name path) for scope matching."""

    name: str
    start_ns: float
    end_ns: float
    text: str


def _kernel_lines(plane):
    lines = list(plane.lines)
    streams = [ln for ln in lines if ln.name.startswith("Stream")]
    return streams or [ln for ln in lines if ln.name not in _DERIVED_LINES]


def device_events(profile, device: int = 0) -> list[DeviceEvent]:
    """Kernel events of GPU `device`, sorted by start. Raises RuntimeError
    when the trace has no such plane or the plane holds no events."""
    name = f"{GPU_PLANE_PREFIX}{device}"
    plane = next((p for p in profile.planes if p.name == name), None)
    if plane is None:
        found = sorted(p.name for p in profile.planes)
        raise RuntimeError(f"trace has no {name} plane (planes: {found})")
    events = []
    for line in _kernel_lines(plane):
        for ev in line.events:
            strs = [str(v) for _, v in ev.stats if isinstance(v, str)]
            events.append(DeviceEvent(
                ev.name, ev.start_ns, ev.start_ns + ev.duration_ns,
                " ".join([ev.name] + strs),
            ))
    if not events:
        raise RuntimeError(f"trace has no kernel events on {name}")
    events.sort(key=lambda e: e.start_ns)
    return events


def iteration_times_ms(events: list[DeviceEvent], marker: str,
                       num_iterations: int | None = None) -> list[float]:
    """Per-iteration device times from kernel events.

    A run of consecutive `marker` events (one named-scope pass, e.g. the
    assembly of one LM iteration) starts an iteration; its time runs to the
    next iteration's start, and the last one to the end of the last event.
    XLA may interleave kernels of other scopes with one pass, splitting it
    into several runs; every iteration runs the same program, so with
    `num_iterations` given the runs are grouped into that many equal
    consecutive groups. Raises RuntimeError when no event matches or the
    runs do not split evenly."""
    starts = []
    prev_hit = False
    for ev in events:
        hit = marker in ev.text
        if hit and not prev_hit:
            starts.append(ev.start_ns)
        prev_hit = hit
    if not starts:
        raise RuntimeError(f"no device events under scope {marker!r}")
    if num_iterations:
        if len(starts) % num_iterations:
            raise RuntimeError(
                f"{len(starts)} runs of scope {marker!r} do not split into "
                f"{num_iterations} iterations"
            )
        starts = starts[:: len(starts) // num_iterations]
    bounds = starts + [max(e.end_ns for e in events)]
    return [(bounds[i + 1] - bounds[i]) / 1e6 for i in range(len(starts))]


def busy_ns(events: list[DeviceEvent]) -> float:
    """Length of the union of the events' [start, end) intervals."""
    total = 0.0
    cur_s = cur_e = None
    for ev in events:  # sorted by start
        if cur_e is None or ev.start_ns > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = ev.start_ns, ev.end_ns
        else:
            cur_e = max(cur_e, ev.end_ns)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_summary(events: list[DeviceEvent], top: int = 10) -> dict:
    """Window, busy time, idle share and the `top` kernels by total time.

    The window runs from the first kernel's start to the last kernel's
    end; busy is the union of kernel intervals; idle share = 1 - busy /
    window."""
    window = max(e.end_ns for e in events) - events[0].start_ns
    busy = busy_ns(events)
    per_op = collections.defaultdict(lambda: [0.0, 0])
    for ev in events:
        per_op[ev.name][0] += ev.end_ns - ev.start_ns
        per_op[ev.name][1] += 1
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "kernels": len(events),
        "top_ops": [
            {"name": k, "total_ms": v[0] / 1e6, "count": v[1]}
            for k, v in ranked
        ],
    }


def scope_breakdown(events: list[DeviceEvent], scopes=PM_SCOPES) -> dict:
    """Total kernel time (ms) under each scope, matched by the scope or its
    function name (first match wins); the rest, including kernels that
    carry no name path, under "other"."""
    out = dict.fromkeys(list(scopes) + ["other"], 0.0)
    for ev in events:
        key = next(
            (s for s, fn in scopes.items() if s in ev.text or fn in ev.text),
            "other",
        )
        out[key] += (ev.end_ns - ev.start_ns) / 1e6
    return out


def compile_per_op(jitted, static, **kwargs):
    """Compile `jitted(**kwargs)` so that its trace names every op (see the
    module docstring). `static` names the static arguments; returns a
    thunk that runs the compiled program on the other arguments."""
    compiled = jitted.lower(**kwargs).compile(compiler_options=PER_OP_EVENTS)
    dynamic = {k: v for k, v in kwargs.items() if k not in static}
    return lambda: compiled(**dynamic)


def run_traced(fn):
    """Run `fn()` (compiled beforehand, by `compile_per_op` for scope
    matching) once under a profiler trace.

    Returns (out, wall_ms, kernel events of GPU 0). Raises RuntimeError
    when the trace holds no GPU kernel events."""
    trace_dir = tempfile.mkdtemp(prefix="ba_trace_")
    try:
        t0 = time.perf_counter()
        with jax.profiler.trace(trace_dir):
            out = jax.block_until_ready(fn())
        wall_ms = (time.perf_counter() - t0) * 1e3
        events = device_events(load_profile(trace_dir))
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    return out, wall_ms, events
