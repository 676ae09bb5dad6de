"""Quantized, lane-packed serving parameters — torch port of
``repro.models.quantized``.

``serve_params`` rewrites a parameter tree; the layer library dispatches
on the container type, so ``decode_step``/``prefill_step`` run
unchanged.  Two packing modes:

  * ``compute="memory"`` (``packed_memory``, the default): every large
    projection kernel becomes a ``PackedLinear`` — w-bit symmetric
    per-output-channel quantization, 32/w values per int32 lane word
    (packed by kernel B6, ``ops.pack_weights``); the layers materialize
    it (kernel B7 fused with the scale, trim and cast,
    ``ops.unpack_dequant``) and multiply in the activation dtype, as the
    reference does;
  * ``compute="sdv"`` (``packed_compute_sdv``): projection kernels — 2-D
    leaves and stacked layer tensors of them — become ``SDVLinear``:
    the same quantization stored as SDV words ([K, G], n output channels
    lane-packed per word), executed through ``kernels/ops.packed_matmul``
    so decode/prefill GEMMs run on the packed arithmetic datapath
    (activations are dynamically quantized per row to ``plan.w_b``
    bits).  Unstacked >2-D kernels (MoE expert banks) keep the memory
    packing.  The short depthwise conv of the SSM/Griffin blocks becomes
    ``BSEGConv`` — taps BSEG-packed through the pre-adder, executed via
    ``kernels/ops.bseg_conv1d`` (kernel B4; activations dynamically
    quantized to the unsigned ``plan.w_i``-bit domain with a zero
    point, per Eqs. 9/10).

``plan_policy`` picks the lane plans under ``compute="sdv"``: the
uniform defaults, or per layer shape through the port's planner
(``repro_torch.planner``; ``"cache"`` also reads and writes its JSON
plan cache), as the reference does.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional

import torch

from ..core.datapath import INT32, BSEGPlan, SDVPlan, plan_bseg, plan_sdv
from ..kernels import bseg_common, ops, ref
from ..quant import quantizer


@dataclasses.dataclass
class PackedLinear:
    """Lane-packed quantized kernel: words [..., d_in, d_out_pad/per]
    int32 (per = 32 // bits fields each), scale [..., 1, d_out_pad] f32
    (the padded columns have scale 1.0 and value 0); ``d_out`` unpads on
    materialize.  A stacked layer tensor keeps a leading layer axis on
    ``words`` and ``scale``; ``layer(i)`` slices one layer off."""
    words: torch.Tensor
    scale: torch.Tensor
    bits: int
    d_out: int

    @property
    def stacked(self) -> bool:
        return self.words.ndim == 3

    def layer(self, i: int) -> "PackedLinear":
        return PackedLinear(words=self.words[i], scale=self.scale[i],
                            bits=self.bits, d_out=self.d_out)


def quantize_linear(kernel: torch.Tensor, bits: int):
    """kernel [..., d_in, d_out] float -> (q [..., d_in, d_out_pad]
    int32, scale [..., 1, d_out_pad] f32): the reference's symmetric
    per-output-channel quantizer, ``d_out`` padded to a multiple of
    32 // bits with value 0 and scale 1.0 — the fields and scales of
    ``pack_linear``."""
    per = 32 // bits
    kf = kernel.to(torch.float32)
    amax = kf.abs().amax(dim=-2, keepdim=True)
    scale = quantizer.symmetric_scale(amax, bits)
    q = quantizer.symmetric_qvalues(kf, scale, bits).to(torch.int32)
    pad = (-kernel.shape[-1]) % per
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
        scale = torch.nn.functional.pad(scale, (0, pad), value=1.0)
    return q, scale.to(torch.float32)


def pack_linear(kernel: torch.Tensor, bits: int) -> PackedLinear:
    """kernel [..., d_in, d_out] float -> PackedLinear: ``quantize_linear``,
    then every row of the [-1, d_out_pad] view packed by
    ``ops.pack_weights`` (kernel B6, one call for a whole stack)."""
    q, scale = quantize_linear(kernel, bits)
    words = ops.pack_weights(q.reshape(-1, q.shape[-1]), w=bits)
    return PackedLinear(
        words=words.reshape(q.shape[:-1] + (words.shape[-1],)),
        scale=scale, bits=bits, d_out=kernel.shape[-1])


@dataclasses.dataclass
class SDVLinear:
    """Arithmetic-packed quantized kernel: SDV storage words [d_in, G]
    int32 (G = ceil(d_out/plan.n) lane groups) — or [2, d_in, G] limb
    planes for the wide DSP48E2/DSP58 plans — and scale [d_out] f32.  A
    stacked layer tensor keeps a leading layer axis on ``words`` and
    ``scale``; ``layer(i)`` slices one layer off."""
    words: torch.Tensor
    scale: torch.Tensor
    plan: SDVPlan
    d_out: int

    @property
    def stacked(self) -> bool:
        base = 2 + (bseg_common.sdv_word_spec(self.plan).limbs == 2)
        return self.words.ndim == base + 1

    def layer(self, i: int) -> "SDVLinear":
        return SDVLinear(words=self.words[i], scale=self.scale[i],
                         plan=self.plan, d_out=self.d_out)


def default_sdv_plan(bits: int, act_bits: int = 8) -> SDVPlan:
    """The serving lane plan: ``bits``-wide signed weights against
    ``act_bits``-wide signed activations on the INT32 datapath."""
    return plan_sdv(INT32, bits, act_bits, signed_a=True, signed_b=True,
                    park_sign_bits=True)


def pack_linear_sdv(kernel: torch.Tensor, plan: SDVPlan) -> SDVLinear:
    """kernel [d_in, d_out] float -> SDVLinear (w_a-bit symmetric
    per-output-channel quantization stored as SDV words).  A stacked
    [L, d_in, d_out] kernel packs each layer with the shared plan and
    keeps the layer axis on every data field."""
    if kernel.ndim not in (2, 3):
        raise ValueError(f"expected a 2-D or stacked 3-D kernel, got "
                         f"{tuple(kernel.shape)}")
    if kernel.ndim == 3:
        per = [pack_linear_sdv(kernel[i], plan)
               for i in range(kernel.shape[0])]
        return SDVLinear(words=torch.stack([p.words for p in per]),
                         scale=torch.stack([p.scale for p in per]),
                         plan=plan, d_out=kernel.shape[-1])
    kf = kernel.to(torch.float32)
    amax = kf.abs().amax(dim=0)
    scale = quantizer.symmetric_scale(amax, plan.w_a)
    q = quantizer.symmetric_qvalues(kf, scale, plan.w_a).to(torch.int32)
    words = ops.prepare_sdv_weights(q.T, plan)               # [d_in, G]
    return SDVLinear(words=words, scale=scale.to(torch.float32),
                     plan=plan, d_out=kernel.shape[-1])


def sdv_matmul_apply(qw: SDVLinear, x: torch.Tensor) -> torch.Tensor:
    """x [..., d_in] @ SDV-packed kernel -> [..., d_out] in x.dtype.

    Activations are dynamically quantized per row (symmetric,
    ``plan.w_b`` bits); the integer GEMM goes through the
    ``packed_matmul`` dispatch, and the two scales dequantize the exact
    int32 lane results.  The GEMM routes to kernels B1/B2 on every
    device (their plain versions on CPU tensors).
    """
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xs = quantizer.symmetric_scale(amax, qw.plan.w_b)
    xq = quantizer.symmetric_qvalues(xf, xs, qw.plan.w_b).to(torch.int32)
    y = ops.packed_matmul(xq, qw.words, plan=qw.plan, m=qw.d_out)
    return (y.to(torch.float32) * xs * qw.scale).to(x.dtype)


@dataclasses.dataclass
class BSEGConv:
    """Arithmetic-packed short depthwise conv: ``kappa`` [G, C] packed
    tap-group factors (pre-adder applied; int32, float32 on FP32M, or
    [2, G, C] int32 limb planes on the wide plans), ``tap_sum`` [C]
    int32 for the zero-point correction, per-channel weight ``scale``
    [C] f32 and float ``bias`` [C]; executed via
    ``kernels/ops.bseg_conv1d``.  A stacked layer tensor keeps a leading
    layer axis on every data field; ``layer(i)`` slices one layer off
    (a contiguous block, as kernel B4 takes it)."""
    kappa: torch.Tensor
    tap_sum: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    plan: BSEGPlan
    taps: int

    @property
    def stacked(self) -> bool:
        base = 2 + (bseg_common.word_spec(self.plan).limbs == 2)
        return self.kappa.ndim == base + 1

    def layer(self, i: int) -> "BSEGConv":
        return BSEGConv(kappa=self.kappa[i], tap_sum=self.tap_sum[i],
                        scale=self.scale[i], bias=self.bias[i],
                        plan=self.plan, taps=self.taps)


def default_bseg_plan(bits: int, act_bits: int = 4) -> BSEGPlan:
    """The serving conv plan: ``bits``-wide signed taps against
    ``act_bits``-wide unsigned inputs on the INT32 datapath."""
    return plan_bseg(INT32, bits, act_bits)


def pack_conv_bseg(conv_params: dict, plan: BSEGPlan) -> BSEGConv:
    """{'w': [..., C, taps] float, 'b': [..., C]} -> BSEGConv (w_k-bit
    symmetric per-channel tap quantization, BSEG-packed through the
    pre-adder).  A leading layer-stack dim keeps the JAX package's
    stacked layout ([L, G, C], or [L, 2, G, C] limb planes), so
    per-layer slicing gives the per-layer container."""
    w, b = conv_params["w"], conv_params["b"]
    if w.ndim not in (2, 3):
        raise ValueError(f"expected [C, taps] or stacked [L, C, taps] "
                         f"conv weights, got {tuple(w.shape)}")
    taps = w.shape[-1]
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=-1, keepdim=True)
    scale = quantizer.symmetric_scale(amax, plan.w_k)
    q = quantizer.symmetric_qvalues(wf, scale, plan.w_k).to(torch.int32)
    kappa, tap_sum = ops.prepare_bseg_taps(q.reshape(-1, taps), plan)
    if w.ndim == 3:                      # [L, C, taps] stacked layers
        stack, c = w.shape[0], w.shape[1]
        if bseg_common.word_spec(plan).limbs == 2:   # [2, G, L*C]
            kappa = kappa.reshape(2, -1, stack, c).permute(2, 0, 1, 3)
        else:                                        # [G, L*C]
            kappa = kappa.reshape(-1, stack, c).transpose(0, 1)
        kappa = kappa.contiguous()                   # [L, (2,) G, C]
        tap_sum = tap_sum.reshape(stack, c)
    return BSEGConv(kappa=kappa, tap_sum=tap_sum,
                    scale=scale[..., 0].to(torch.float32),
                    bias=b.to(torch.float32), plan=plan, taps=taps)


def bseg_conv_apply(qc: BSEGConv, x: torch.Tensor, *,
                    state: Optional[torch.Tensor] = None):
    """x [B, S, C] float through the BSEG-packed causal depthwise conv.

    Activations (history included) are dynamically quantized per call —
    asymmetric, with one min/max over the whole [B, taps-1+S, C] tensor,
    to the *unsigned* ``plan.w_i``-bit datapath domain with zero point
    2^(w_i - 1) — then the exact integer correlation runs through
    ``kernels/ops.bseg_conv1d`` (kernel B4); the two scales and the tap
    sums dequantize.  Mirrors ``ssm.short_conv_apply``: returns
    (y [B, S, C], new_state [B, taps-1, C]).
    """
    taps = qc.taps
    if state is None:
        state = torch.zeros((x.shape[0], taps - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xfull = torch.cat([state.to(x.dtype), x], dim=1)
    xf = xfull.to(torch.float32)
    lo = xf.min()
    hi = xf.max()
    xs = quantizer.asymmetric_scale(lo, hi, qc.plan.w_i)
    zp = quantizer.asymmetric_zero_point(qc.plan.w_i)
    xq_u = quantizer.asymmetric_qvalues(xf, lo, xs, qc.plan.w_i)
    xq = (xq_u - zp).to(torch.int8)              # signed datapath input
    y_int = ops.bseg_conv1d(xq, qc.kappa, qc.tap_sum, plan=qc.plan,
                            n_taps=taps, zero_point=zp,
                            padding="causal")[:, taps - 1:, :]
    # sum_q w x = scale_w * xs * sum_q q*xq_u + lo * scale_w * sum_q q
    ts = qc.tap_sum.to(torch.float32)
    y = qc.scale * xs * (y_int.to(torch.float32) + zp * ts) \
        + lo * qc.scale * ts + qc.bias
    new_state = xfull[:, xfull.shape[1] - (taps - 1):, :]
    return y.to(x.dtype), new_state


def materialize(pl, dtype=torch.bfloat16) -> torch.Tensor:
    """Unpack + dequantize -> [..., d_in, d_out] in ``dtype``.

    A ``PackedLinear`` is one ``ops.unpack_dequant`` call (kernel B7 fused
    with the dequant) on the [-1, nw] view of its words, one group of
    ``d_in`` rows per layer: each field in float32 times its column's
    scale, trimmed to ``d_out`` and cast to ``dtype`` (bfloat16 or
    float32), bit for bit the reference's unpack, scale, trim and cast."""
    if isinstance(pl, PackedLinear):
        out = ops.unpack_dequant(pl.words.reshape(-1, pl.words.shape[-1]),
                                 pl.scale, w=pl.bits, d_out=pl.d_out,
                                 rows_per_scale=pl.words.shape[-2],
                                 dtype=dtype)
        return out.reshape(pl.words.shape[:-1] + (pl.d_out,))
    if pl.stacked:
        return torch.stack([materialize(pl.layer(i), dtype)
                            for i in range(pl.words.shape[0])])
    w_int = ref.sdv_unpack_words_ref(pl.words, plan=pl.plan)
    return (w_int[:, :pl.d_out].to(torch.float32)
            * pl.scale[None, :]).to(dtype)


def is_packed(x) -> bool:
    return isinstance(x, (PackedLinear, SDVLinear, BSEGConv))


def is_sdv(x) -> bool:
    return isinstance(x, SDVLinear)


def count_packed(tree) -> Dict[str, int]:
    """Per-layer count of the packed containers in a serve tree:
    ``{"memory": ..., "sdv": ..., "bseg": ...}``, a stacked container
    counting once per layer."""
    out = {"memory": 0, "sdv": 0, "bseg": 0}
    keys = {PackedLinear: "memory", SDVLinear: "sdv", BSEGConv: "bseg"}

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif type(node) in keys:
            lead = node.kappa if isinstance(node, BSEGConv) else node.words
            out[keys[type(node)]] += lead.shape[0] if node.stacked else 1

    walk(tree)
    return out


_QUANT_LEAF_NAMES = ("kernel", "wi_gate", "wi_up", "wo")
_SKIP_CONTAINERS = ("router", "conv", "proj_patches")
#: top-level containers whose leading axis is the stacked layer axis —
#: a 3-D kernel under one of these is a stack of 2-D GEMMs
_STACKED_CONTAINERS = ("blocks", "groups", "tail", "enc_blocks",
                       "dec_blocks")


def _stacked_leading_axis(path: str) -> bool:
    head = path.split("/", 1)[0]
    return head in _STACKED_CONTAINERS or head.startswith("blocks_dense")


#: decode micro-batch rows the planner dimensions matmul layers for
PLANNER_DECODE_ROWS = 8


def serve_params(params: Any, bits: int = 4, min_size: int = 1 << 16,
                 compute: str = "memory", act_bits: int = 8,
                 conv_bseg: Optional[bool] = None,
                 plan_policy: str = "default",
                 plan_cache: Optional[str] = None,
                 rows: Optional[int] = None) -> Any:
    """Rewrite a parameter tree for quantized packed serving.

    Kernels named ``kernel``/``wi_gate``/``wi_up``/``wo`` with at least
    ``min_size`` elements, and the LM head, are packed.
    ``compute="memory"`` packs each as ``PackedLinear`` (lane words,
    kernel B6); ``compute="sdv"`` packs 2-D kernels and stacked layer
    tensors of 2-D kernels (a 3-D leaf under ``blocks``, ``groups``, ...
    packs per layer with a shared plan) as ``SDVLinear``, keeping memory
    packing for unstacked >2-D kernels (MoE expert banks).  ``conv_bseg``
    (default: on under ``compute="sdv"``, off under memory, as in the
    reference) packs the SSM/Griffin short-conv containers as
    ``BSEGConv``; off keeps the float conv dict.

    ``plan_policy`` selects the lane plans under ``compute="sdv"``:
    ``"default"`` keeps the uniform ``default_sdv_plan(bits, act_bits)``
    / ``default_bseg_plan(min(bits, 4))``; ``"auto"`` searches per layer
    shape through the planner (``repro_torch.planner.choose_plan``);
    ``"cache"`` additionally reuses/persists choices in the JSON plan
    cache at ``plan_cache`` (default ``$REPRO_PLAN_CACHE``).  A layer
    whose chosen plan would land on the plain ref route is reported
    once per shape via ``warnings.warn``.  ``rows`` is the decode
    micro-batch row count the planner dimensions matmul layers for
    (default ``PLANNER_DECODE_ROWS``); the serving engine passes each
    bucket's batch width.
    """
    if compute not in ("memory", "sdv"):
        raise ValueError(f"unknown packed compute mode {compute!r}")
    if rows is None:
        rows = PLANNER_DECODE_ROWS
    if plan_policy not in ("default", "auto", "cache"):
        raise ValueError(f"unknown plan policy {plan_policy!r}")
    sdv_mode = compute == "sdv"
    if plan_policy != "default" and not sdv_mode:
        raise ValueError(
            f"plan_policy={plan_policy!r} plans arithmetic-packing "
            f"lane plans, which only exist under compute='sdv' — "
            f"memory packing has no plan to choose")
    # the uniform default plan is only required under the default
    # policy: the planner can still find a (possibly wider-datapath)
    # plan for bit configs the INT32 default cannot pack
    plan = default_sdv_plan(bits, act_bits) \
        if sdv_mode and plan_policy == "default" else None
    if conv_bseg is None:
        conv_bseg = sdv_mode
    conv_plan = default_bseg_plan(min(bits, 4)) if conv_bseg else None

    planner_ctx = None
    if plan_policy != "default":
        from .. import planner as _planner
        cache = _planner.PlanCache.load(plan_cache) \
            if plan_policy == "cache" else None
        planner_ctx = {"mod": _planner, "cache": cache, "memo": {},
                       "warned": set()}

    def _choose(layer):
        ctx = planner_ctx
        mk = layer.key()
        if mk not in ctx["memo"]:
            choice = None
            if ctx["cache"] is not None:
                choice = ctx["cache"].get_choice(layer)
            if choice is None:
                choice = ctx["mod"].choose_plan(layer)
                if ctx["cache"] is not None:
                    ctx["cache"].put_choice(choice, source="analytic")
            ctx["memo"][mk] = choice
        choice = ctx["memo"][mk]
        if choice.cost.route == "ref" and mk not in ctx["warned"]:
            ctx["warned"].add(mk)
            warnings.warn(
                f"serve_params: layer {layer.name!r} ({mk}) lands on "
                f"the plain ref route — {choice.cost.reason}",
                stacklevel=3)
        return choice.plan

    def layer_plan(name, v):
        """The SDV plan for one (possibly stacked) 2-D kernel leaf."""
        if planner_ctx is None:
            return plan
        layer = planner_ctx["mod"].matmul_spec(
            name, rows, v.shape[-2], v.shape[-1],
            w_bits=bits, a_bits=act_bits)
        return _choose(layer)

    def conv_layer_plan(name, w):
        """The BSEG plan for one short-conv container."""
        if planner_ctx is None:
            return conv_plan
        layer = planner_ctx["mod"].conv1d_spec(
            name, w.shape[-2], w.shape[-1], w_bits=min(bits, 4),
            a_bits=4, rows=rows)
        chosen = _choose(layer)
        return chosen if isinstance(chosen, BSEGPlan) else conv_plan

    def quantize(v, name):
        if sdv_mode and (v.ndim == 2 or
                         (v.ndim == 3 and _stacked_leading_axis(name))):
            return pack_linear_sdv(v, layer_plan(name, v))
        return pack_linear(v, bits)

    def walk(tree, name):
        out = {}
        for k, v in tree.items():
            path = f"{name}/{k}" if name else k
            if k == "conv" and conv_plan is not None \
                    and isinstance(v, dict) and "w" in v \
                    and v["w"].ndim in (2, 3):
                out[k] = pack_conv_bseg(v, conv_layer_plan(path, v["w"]))
            elif k in _SKIP_CONTAINERS:
                out[k] = v
            elif isinstance(v, dict):
                out[k] = walk(v, path)
            elif k in _QUANT_LEAF_NAMES and isinstance(v, torch.Tensor) \
                    and v.ndim >= 2 and v.numel() >= min_size:
                out[k] = quantize(v, path)
            else:
                out[k] = v
        return out

    out = walk(params, "")
    # the LM head is a plain tensor leaf at top level
    if "lm_head" in out and not is_packed(out["lm_head"]):
        out["lm_head"] = quantize(out["lm_head"], "lm_head")
    if planner_ctx is not None and planner_ctx["cache"] is not None:
        planner_ctx["cache"].save()
    return out
