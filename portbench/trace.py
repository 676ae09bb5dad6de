"""Reading a ``torch.profiler`` run: device events from the raw kineto
trace, device time by launching host op, the busy union and idle gaps
of a window, and the ``breakdown`` of the result line.

``device_events`` and ``device_ms_under`` follow ``chip_smoke.py``'s
readers of the same names (raw kineto events: the profiler's
``key_averages`` costs about 0.5 ms an event on the host), with each
device event's start kept for the window's union.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

#: the benchmark's own profiler ranges: the one around the measured
#: window, and the prefix of them all
RANGES = "portbench."
WINDOW = RANGES + "window"


class HostOp:
    """A host event as ``device_ms_under``'s predicates see it: ``key``
    (its name) and ``input_shapes``."""
    __slots__ = ("_e",)

    def __init__(self, e):
        self._e = e

    @property
    def key(self):
        return self._e.name()

    @property
    def input_shapes(self):
        return self._e.shapes()


@dataclass
class DeviceEvent:
    name: str
    start_ns: int
    dur_ns: int
    op: object          # the kineto host event that launched it, or None


@dataclass
class Trace:
    """What a traced window leaves: its bounds, the device events inside
    it and the host events by correlation id."""
    start_ns: int
    end_ns: int
    events: List[DeviceEvent]
    host: Dict[int, object]
    thread: Optional[int]

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def read(prof) -> Trace:
    """The window range's bounds and the device events (kernels, copies,
    memsets) that start inside it; ranges' own device-side entries are
    left out, and the benchmark's own by name.  A trace of device
    activity alone holds no range: its window runs from the first
    device event's start to the last one's end."""
    from torch.autograd import DeviceType
    host, dev, window = {}, [], None
    ranges = set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name() == WINDOW and window is None:
                window = e
            if getattr(e, "is_user_annotation", lambda: False)():
                ranges.add(e.name())
            if not e.is_async() and e.linked_correlation_id() == 0:
                host[e.correlation_id()] = e
        else:
            dev.append(e)
    dev = [e for e in dev if e.name() not in ranges
           and not e.name().startswith(RANGES)]
    if window is not None:
        lo, hi = window.start_ns(), window.end_ns()
        thread = window.start_thread_id()
    elif dev:
        lo = min(e.start_ns() for e in dev)
        hi = max(e.start_ns() + e.duration_ns() for e in dev)
        thread = None
    else:
        return Trace(0, 0, [], host, None)
    events = [DeviceEvent(e.name(), e.start_ns(), e.duration_ns(),
                          host.get(e.linked_correlation_id()))
              for e in dev if lo <= e.start_ns() < hi]
    return Trace(lo, hi, events, host, thread)


def device_ms_under(trace: Trace, pick) -> float:
    """Device ms of the events launched inside a host op that ``pick``
    (a predicate on a ``HostOp``) selects: the launching op is that op
    or runs within it on the same thread."""
    spans: Dict[int, list] = {}
    for e in trace.host.values():
        if pick(HostOp(e)):
            spans.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns()))
    merged = {}
    for tid, iv in spans.items():
        out: list = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        merged[tid] = ([a for a, _ in out], [b for _, b in out])
    total = 0.0
    for ev in trace.events:
        op = ev.op
        if op is None or op.start_thread_id() not in merged:
            continue
        starts, ends = merged[op.start_thread_id()]
        i = bisect.bisect_right(starts, op.start_ns()) - 1
        if i >= 0 and op.end_ns() <= ends[i]:
            total += ev.dur_ns / 1e6
    return total


def device_ms_named(trace: Trace, part: str) -> float:
    """Device ms of the events whose name contains ``part``."""
    return sum(e.dur_ns for e in trace.events if part in e.name) / 1e6


def busy_intervals(trace: Trace) -> List[Tuple[int, int]]:
    """The union of the device events' intervals, clipped to the
    window, in order."""
    out: List[list] = []
    for e in sorted(trace.events, key=lambda e: e.start_ns):
        a = max(e.start_ns, trace.start_ns)
        b = min(e.start_ns + e.dur_ns, trace.end_ns)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace)) / 1e9


def idle_gaps(trace: Trace) -> List[Tuple[int, int]]:
    """The stretches of the window with nothing running on the device."""
    gaps, t = [], trace.start_ns
    for a, b in busy_intervals(trace):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if trace.end_ns > t:
        gaps.append((t, trace.end_ns))
    return gaps


def _host_label(ops, starts, ends, mid, depth: int = 64) -> str:
    """The innermost host op on the window's thread running at ``mid``
    (the latest to start of those that span it), looked for among the
    ``depth`` ops that started last before it."""
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(-1, i - depth), -1):
        if ends[j] >= mid:
            return ops[j].name()
    return "python (no op running)"


def breakdown(trace: Trace, host: Trace, top: int = 10) -> dict:
    """The contract's ``breakdown``: the device operations that took most
    time in ``trace``, and the idle time of ``host`` (a window traced
    with host ops) summed by what the host was doing in each gap (the
    innermost host op at its middle), seconds each, ``top`` of
    either."""
    by_name: Dict[str, float] = {}
    for e in trace.events:
        key = e.name[:120]
        by_name[key] = by_name.get(key, 0.0) + e.dur_ns / 1e9
    ops = sorted((e for e in host.host.values()
                  if e.start_thread_id() == host.thread
                  and e.name() != WINDOW),
                 key=lambda e: e.start_ns())
    starts = [e.start_ns() for e in ops]
    ends = [e.end_ns() for e in ops]
    by_host: Dict[str, float] = {}
    for a, b in idle_gaps(host):
        key = _host_label(ops, starts, ends, (a + b) // 2)[:120]
        by_host[key] = by_host.get(key, 0.0) + (b - a) / 1e9

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": ranked(by_name), "idle_gaps": ranked(by_host)}
