"""UltraNet-INT4 — the paper's evaluation model (Tabs. II-IV).

Torch port of ``repro.models.ultranet``.  DAC-SDC 2020 object-detection
CNN: 8 conv3x3 stages (4 with a 2x2 maxpool) plus a 1x1 head, quantized
W4A4, NHWC activations and ``[C_out, C_in, k, k]`` weights as in the
reference.  Two execution paths, and a benchmark baseline:

  * ``mode="ref"``  — the exact integer conv oracle
    (``kernels/ref.conv2d_int_ref``, float64 products, exact);
  * ``mode="bseg"`` — every conv goes through the
    ``kernels/ops.packed_conv2d`` dispatch layer: the 3x3 stages run on
    kernel B3 (``csrc/bseg.cu``, one launch per conv), the 1x1 head on
    the SDV GEMM B2 through im2col; bit-exact against the oracle.  With
    ``plans=`` each conv takes its own bare ``BSEGPlan`` (a 1x1 head on
    a wide DSP48E2/DSP58 or FP32M word then runs on B3 as well) or
    ``SDVPlan`` (the conv becomes an im2col GEMM on that plan).

``mode="bseg_jnp"`` keeps the reference's broadcast-materialized seed
emulation (one ``core.bseg.bseg_conv1d`` pass per kernel row, the
activations broadcast to [B, H, C_out, C_in, W]) as a benchmark
baseline only: it is on no serving path, and at 416x416 its broadcast
alone is tens of GB.

Thresholding (FINN-style) is modeled as requantize -> unsigned int4
activations: the signed-kernel x unsigned-input regime of Eqs. 9/10.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.bseg import bseg_conv1d, bseg_num_multiplies
from ..core.datapath import INT32, BSEGPlan, SDVPlan, plan_bseg
from ..device import resolve_device
from ..kernels import ops, ref

# (out_channels, kernel, pool_after)
ULTRANET_LAYERS: List[Tuple[int, int, bool]] = [
    (16, 3, True), (32, 3, True), (64, 3, True), (64, 3, True),
    (64, 3, False), (64, 3, False), (64, 3, False), (64, 3, False),
]
HEAD_CHANNELS = 36          # 6 anchors x (4 box + 1 obj + 1 cls)
W_BITS = 4
A_BITS = 4

ULTRANET_MODES = ("ref", "bseg", "bseg_jnp")


@dataclasses.dataclass
class UltraNetParams:
    convs: List[torch.Tensor]       # int8 [C_out, C_in, k, k] (w4 values)
    head: torch.Tensor              # int8 [36, 64, 1, 1]


def init_ultranet(seed: int = 0, in_ch: int = 3,
                  device="cuda") -> UltraNetParams:
    """Random W4 weights drawn from ``np.random.default_rng(seed)`` in
    the reference's order, so both packages hold the same weights."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    convs = []
    cin = in_ch
    for cout, k, _ in ULTRANET_LAYERS:
        convs.append(torch.tensor(rng.integers(-8, 8, (cout, cin, k, k)),
                                  dtype=torch.int8, device=dev))
        cin = cout
    head = torch.tensor(rng.integers(-8, 8, (HEAD_CHANNELS, cin, 1, 1)),
                        dtype=torch.int8, device=dev)
    return UltraNetParams(convs=convs, head=head)


def _requant_unsigned(acc: torch.Tensor, bits: int = A_BITS) -> torch.Tensor:
    """FINN-style thresholding stub: shift-requantize the accumulator to
    an unsigned ``bits``-wide activation (arithmetic shift on int32)."""
    shifted = acc.to(torch.int32) >> 6
    return shifted.clamp(0, (1 << bits) - 1)


def _conv2d_planned(x: torch.Tensor, w: torch.Tensor, chosen,
                    base_plan) -> torch.Tensor:
    """One conv on its chosen plan (a bare plan, or anything with a
    ``.plan``).  A BSEG plan dispatches as usual; an SDV plan forces the
    im2col route with that plan."""
    plan = getattr(chosen, "plan", chosen)
    if isinstance(plan, SDVPlan):
        return ops.packed_conv2d(x, w, plan=base_plan, mode="im2col",
                                 zero_point=0, sdv_plan=plan)
    if not isinstance(plan, BSEGPlan):
        raise TypeError(f"not a packing plan: {chosen!r}")
    return ops.packed_conv2d(x, w, plan=plan, mode="auto", zero_point=0)


def _conv2d_bseg_jnp(x: torch.Tensor, w: torch.Tensor,
                     plan) -> torch.Tensor:
    """SEED BASELINE (benchmarks only): the conv through the cycle-level
    BSEG 1-D oracle, one pass per kernel row with activations
    broadcast-materialized to [B, H, C_out, C_in, W]."""
    b, hh, ww, cin = x.shape
    cout, _, kh, kw = w.shape
    pad = kh // 2
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    total = torch.zeros((b, hh, ww, cout), dtype=torch.int32,
                        device=x.device)
    for r in range(kh):
        rows = xp[:, r:r + hh, :, :].movedim(-1, 2)      # [B,hh,cin,Wp]
        taps = w[:, :, r, :].to(torch.int32)             # [cout,cin,kw]
        shape = (b, hh, cout, cin)
        y = bseg_conv1d(taps[None, None].expand(shape + (kw,)),
                        rows[:, :, None].expand(shape + (rows.shape[-1],)),
                        plan, input_zero_point=0)        # [...,W_out]
        total = total + y.sum(dim=3).movedim(2, -1)
    return total


def _conv2d(x, w, plan, mode: str, chosen=None):
    if chosen is not None and mode == "bseg":
        return _conv2d_planned(x, w, chosen, plan)
    if mode == "ref":
        return ref.conv2d_int_ref(x, w)
    if mode == "bseg":
        return ops.packed_conv2d(x, w, plan=plan, mode="auto", zero_point=0)
    if mode == "bseg_jnp":
        return _conv2d_bseg_jnp(x, w, plan)
    raise ValueError(f"unknown ultranet mode {mode!r}; "
                     f"expected one of {ULTRANET_MODES}")


def ultranet_forward(params: UltraNetParams, img_q, *, mode: str = "ref",
                     plans: Optional[Sequence] = None,
                     device="cuda") -> torch.Tensor:
    """img_q: [B, H, W, 3] unsigned int4 values (tensor or array).
    Returns the head output [B, H/16, W/16, 36] int32 on ``device``,
    where the parameters must lie.

    ``plans`` (``mode="bseg"`` only) gives each of the 9 convs its own
    plan; ``None`` keeps the W4A4 INT32 default plan on every layer.
    Any feasible plan covers the int4 data, so the output stays
    bit-exact against ``mode="ref"`` either way.
    """
    dev = resolve_device(device)
    on = params.head.device
    if on.type != dev.type or dev.index not in (None, on.index):
        raise ValueError(f"parameters on {on}, forward asked for {dev}")
    plan = plan_bseg(INT32, W_BITS, A_BITS)
    n_convs = len(ULTRANET_LAYERS) + 1
    if plans is not None:
        if mode != "bseg":
            raise ValueError("per-layer plans only apply to mode='bseg'")
        if len(plans) != n_convs:
            raise ValueError(f"need {n_convs} per-layer plans "
                             f"(8 stages + head), got {len(plans)}")
    chosen = plans if plans is not None else [None] * n_convs
    x = torch.as_tensor(img_q, device=on).to(torch.int32)
    for (cout, k, pool), w, ch in zip(ULTRANET_LAYERS, params.convs,
                                      chosen):
        x = _requant_unsigned(_conv2d(x, w, plan, mode, chosen=ch))
        if pool:
            b, hh, ww, c = x.shape
            x = x.reshape(b, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))
    return _conv2d(x, params.head, plan, mode, chosen=chosen[-1])


def ultranet_layer_shapes(h: int, w: int, in_ch: int = 3):
    """Per-conv activation/weight shapes at an ``h x w`` input frame:
    [{'cin', 'cout', 'k', 'h', 'w'}] for the 8 stages + the head."""
    shapes = []
    cin, hh, ww = in_ch, h, w
    for cout, k, pool in ULTRANET_LAYERS:
        shapes.append({"cin": cin, "cout": cout, "k": k, "h": hh, "w": ww})
        cin = cout
        if pool:
            hh, ww = hh // 2, ww // 2
    shapes.append({"cin": cin, "cout": HEAD_CHANNELS, "k": 1,
                   "h": hh, "w": ww})
    return shapes


def ultranet_conv_routes(h: int, w: int) -> List[str]:
    """The packed_conv2d dispatch decision per conv at this frame."""
    plan = plan_bseg(INT32, W_BITS, A_BITS)
    return [ops.select_conv_route(
        (1, s["h"], s["w"], s["cin"]),
        (s["cout"], s["cin"], s["k"], s["k"]), plan=plan)
        for s in ultranet_layer_shapes(h, w)]


def ultranet_multiplies(h: int, w: int, *, mode: str) -> dict:
    """Wide-multiply counts per frame (the FPS/DSP currency of Tab II)."""
    plan = plan_bseg(INT32, W_BITS, A_BITS)
    per_layer = []
    cin = 3
    hh, ww = h, w
    for cout, k, pool in ULTRANET_LAYERS:
        macs = hh * ww * cout * cin * k * k
        if mode == "naive":
            mults = macs
        else:
            # k row-convs of k taps over width ww, per (cin, cout, row)
            mults = hh * cout * cin * k \
                * bseg_num_multiplies(k, ww + 2 * (k // 2), plan)
        per_layer.append({"macs": macs, "mults": mults})
        cin = cout
        if pool:
            hh, ww = hh // 2, ww // 2
    macs = hh * ww * HEAD_CHANNELS * cin
    per_layer.append({"macs": macs,
                      "mults": macs if mode == "naive"
                      else -(-macs // plan.density)})
    total_macs = sum(p["macs"] for p in per_layer)
    total_mults = sum(p["mults"] for p in per_layer)
    return {"per_layer": per_layer, "total_macs": total_macs,
            "total_mults": total_mults,
            "density_achieved": total_macs / total_mults}
