"""Device time under the program's own spans (``repro_torch.tracing``):
the kernels that ``trace.device_ms_under`` puts under the spans of the
given names, read from the stretch traced with host ops (``run.host``),
the one where the profiler records the spans.  A kernel launched through
``ctypes`` (B2, B7) links to the innermost span open at its launch, an
aten op's kernels to that op, which runs inside the span.

Each reader returns None where the stretch holds none of the named
spans: a program that opens no such span (an older one), or a cell
whose model has no such layer.
"""
from __future__ import annotations

from typing import Iterable, Optional

from . import trace as T

#: the prefix of the program's span names
PROGRAM = "repro_torch."


def span_ms(trace: T.Trace, spans: Iterable[str]) -> Optional[float]:
    """Device ms of the events launched under any of ``spans`` (names
    after ``PROGRAM``), or None where the trace holds none of them."""
    names = frozenset(PROGRAM + s for s in spans)
    if not any(e.name() in names for e in trace.host.values()):
        return None
    return T.device_ms_under(trace, lambda op: op.key in names)


def _host_ms(run, spans) -> Optional[float]:
    host = run.host
    if host is None or not host.trace.events:
        return None
    return span_ms(host.trace, spans)


def ms_per_call(run, spans) -> Optional[float]:
    """Device ms a model call under ``spans``, over the host stretch's
    model calls (``work["calls"]``: [rows, real rows, count])."""
    ms = _host_ms(run, spans)
    calls = sum(n for _, _, n in run.host.work["calls"]) if run.host else 0
    return ms / calls if ms is not None and calls else None


def ms_per_k_tokens(run, spans) -> Optional[float]:
    """Device ms under ``spans`` a thousand of the host stretch's prompt
    tokens (``work["tokens"]``)."""
    ms = _host_ms(run, spans)
    tokens = run.host.work["tokens"] if run.host else 0
    return ms / (tokens / 1e3) if ms is not None and tokens else None
