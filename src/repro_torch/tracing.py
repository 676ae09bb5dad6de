"""Profiler spans at the layer boundaries of the model step, and a record
of the MoE layers' expert choices.

``span(name)`` marks one layer (or part of one) for ``torch.profiler``.
While a profiler session runs it opens a profiler range of that name, a
function-scope ``RecordFunction`` (``torch._C._profiler._RecordFunctionFast``):
the range lands in the profiler's kineto trace on the profiler's clock,
nested under the ranges and ops open around it, and ``export_chrome_trace``
writes it out.  The device work launched inside it links to it: an aten
op's kernels through that op, and a kernel launched through ``ctypes``
(B2, B7), which has no op of its own, to the innermost span.  (A
user-scope ``torch.profiler.record_function`` range leaves such a launch
unlinked.)  With no profiler running ``span`` returns one shared no-op
context: one profiler-state check, no allocation, no dispatcher call.
There is no other switch: the spans are on exactly while a profiler
session runs.

Names are ``repro_torch.<layer>[.<part>]``:

- ``repro_torch.decode_step`` / ``prefill_step`` / ``verify_step``: the
  whole model call (``models/transformer.py``);
- ``repro_torch.attn``: one layer's attention, inside it ``.qkv`` (the
  projections with RoPE), ``.kv`` (quantize, cache scatter, and the
  cache read back as float32 with its scales), ``.core`` (scores, mask,
  softmax, values) and ``.out`` (the ``wo`` projection);
- ``repro_torch.moe``: one layer's MoE FFN, inside it ``.route`` (router
  and top-k), ``.dispatch`` (scatter into ``[E, cap, d]``), ``.experts``
  (each bank materialized, the three products and the activation) and
  ``.combine`` (gather, weights and the shared expert);
- ``repro_torch.mlp``: the dense FFN; ``repro_torch.head``: the LM head
  (the head materialized and its product);
- ``repro_torch.ssm.scan``, ``repro_torch.rglru.scan``: the chunked SSD
  scan and the RG-LRU's associative scan; ``repro_torch.qat.pack``: the
  SDV weight packing (``kernels/ops.prepare_sdv_weights``).

``expert_routes()`` collects, while it is open, what each MoE layer routes
(``layers.moe_route``'s ``(top_e, slot, keep)``, as returned: no copy, no
device work), in call order.  With no record open the cost is one check.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Iterator, List, Tuple

import torch

_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def span(name: str):
    """A context that marks ``name`` in a running profiler's trace, or
    the shared no-op context when no profiler runs."""
    if not _profiling():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def spanned(name: str):
    """Decorator: the whole call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


#: the expert-choice records open now, innermost last
_ROUTES: List[list] = []

Route = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@contextlib.contextmanager
def expert_routes() -> Iterator[List[Route]]:
    """Collect ``(top_e [T, k], slot [T*k], keep [T*k])`` of every MoE
    layer the program runs while the block is open, in call order.
    Records nest: each open one sees every call."""
    calls: List[Route] = []
    _ROUTES.append(calls)
    try:
        yield calls
    finally:
        _ROUTES[:] = [c for c in _ROUTES if c is not calls]


def record_route(top_e, slot, keep) -> None:
    """Hand one MoE layer's routing to the open records, if any."""
    for calls in _ROUTES:
        calls.append((top_e, slot, keep))
