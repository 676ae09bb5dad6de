"""The arithmetic of the per-layer metrics, which the readers under
``metrics/`` apply to a traced run (``harness.LayerRun``).  Each returns
None where the trace holds nothing to read: a run without device
events, or a cell where the kernel does not run.
"""
from __future__ import annotations

from . import roofline as R
from . import trace as T

B2_KERNEL = "sdv_gemm_kernel"
B7_KERNEL = "unpack_dequant_kernel"


def _on_device(run) -> bool:
    return bool(run.trace.events)


def step_mfu_pct(run):
    """Model FLOPs of the untraced stretch's tokens
    (``roofline.model_flops``) over its seconds on the host clock at the
    bf16 peak, %."""
    if not _on_device(run) or not run.timed:
        return None
    w = run.timed
    flops = R.model_flops(run.arch, tokens=w["tokens"],
                          context_sum=w["context_sum"],
                          logit_rows=w["logit_rows"])
    return 100.0 * flops / (w["seconds"] * R.PEAK_BF16_FLOP_S)


def b2_roofline_pct(run):
    """B2's bound over the traced stretch's model calls (every packed
    projection at each call's real rows) over B2's device time, %."""
    port = run.port
    bound = sum(n * R.b2_step_bound_s(run.arch, rows, real,
                                      port["weight_bits"], port["act_bits"])
                for rows, real, n in run.work["calls"])
    if bound == 0 or not _on_device(run):
        return None
    return R.share_pct(bound, T.device_ms_named(run.trace, B2_KERNEL) / 1e3)


def b7_roofline_pct(run):
    """B7's bound over the traced stretch's model calls (every bank
    unpacked once a call) over B7's device time, %."""
    calls = sum(n for _, _, n in run.work["calls"])
    bound = calls * R.b7_step_bound_s(run.arch, run.port["weight_bits"])
    if bound == 0 or not _on_device(run):
        return None
    return R.share_pct(bound, T.device_ms_named(run.trace, B7_KERNEL) / 1e3)


def moe_dev_ms(run):
    """Device ms a model call of the MoE FFN's bank work, read from the
    stretch traced with host ops and input shapes: the B7 launches and
    the expert products (the ``aten::bmm`` ops whose weight operand is a
    bank)."""
    banks = [[e, k, n] for e, k, n in R.bank_shapes(run.arch)]
    run = run.host
    if not banks or run is None or not _on_device(run):
        return None

    def bank_bmm(op):
        if op.key != "aten::bmm":
            return False
        shapes = op.input_shapes
        return len(shapes) > 1 and list(shapes[1]) in banks
    ms = T.device_ms_named(run.trace, B7_KERNEL) \
        + T.device_ms_under(run.trace, bank_bmm)
    calls = sum(n for _, _, n in run.work["calls"])
    return ms / calls if calls else None


def idle_pct(run):
    """Share of the traced stretch with no kernel, copy or memset running
    on the device (the union of their intervals), %.  The profiler's
    host cost lengthens a host-bound step, so this is an upper bound on
    the idle share of an untraced run."""
    if not _on_device(run):
        return None
    return 100.0 * (1.0 - T.busy_s(run.trace) / run.window_s)
