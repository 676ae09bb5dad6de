"""Straight-through-estimator layers on the packed datapath — torch port
of ``repro.train.qat.ste``.

The QAT forward must see EXACTLY the arithmetic the serving containers
will run — same quantization rule (``quant/quantizer.py``), same exact
integer GEMM/conv, same dequantization order — or the trained network
and the served network silently diverge.  Three pieces:

  * ``ste_dense`` / ``ste_conv2d``: ``torch.autograd.Function`` layers
    whose *forward* quantizes weights (per-output-channel symmetric)
    and activations (per-row symmetric for GEMM; min/max asymmetric
    unsigned for conv, Eqs. 9/10) with the shared rule, runs the exact
    integer correlation through ``kernels/ops.packed_matmul`` (kernel
    B2 on the card at training row counts) / ``packed_conv2d`` (B3) on
    a planner-chosen plan, and dequantizes — and whose *backward* flows
    through the float STE surrogate (gradients of ``fq(x) @ fq(w)``
    with straight-through quantizers: plain float32 products).  Every
    packed route returns the exact int32 correlation and the scaling
    ops are identical elementwise, so the packed forward is bit-exact
    against the plain integer product (``plan=None``) on every
    enumerable plan, and against the JAX package's forward.
  * ``QATLinear``: a container holding the float master kernel (its one
    tree leaf — gradients flow to it) plus the bitwidths, the plan and
    ``use_kernel``.  ``models/layers.dense_apply`` and
    ``models/transformer.unembed_hidden`` duck-dispatch on
    ``qat_apply``, so ``forward``/``loss_fn`` run QAT unchanged; a
    stacked layer tensor keeps its leading layer axis on the kernel and
    ``layer(i)`` slices it off (as ``SDVLinear.layer`` does).
  * ``qat_params``: mirrors ``serve_params``'s walk (same leaf names,
    same stacked-container rules) wrapping each packable kernel in a
    ``QATLinear`` — the training-time twin of the serving rewrite, so
    QAT trains precisely the layer set that will later pack.

``use_kernel`` picks the dispatch's route as the JAX package's does:
true (the default exactly when the input lies on the card) routes by
the dispatch table, which launches the CUDA kernels on CUDA tensors;
false takes the plain exact route.  Without a plan the forward is the
exact integer product in float64 (``kernels/ref._exact_int_matmul``:
CUDA has no int32 matmul; exact below 2^53).  The backward saves the
quantized integers and scales (int8 for at most 8 bits) and rebuilds
the fake-quant float operands from them, which are the same float32
values the JAX package saves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.datapath import BSEGPlan, SDVPlan
from ...kernels import ops, ref
from ...quant import quantizer
from ...tree import register_container


def _use_kernel_default(use_kernel: Optional[bool], device) -> bool:
    # the CUDA kernels on the card, the plain exact route elsewhere —
    # the rule of the JAX package (Pallas on an accelerator only)
    if use_kernel is None:
        return torch.device(device).type == "cuda"
    return use_kernel


def _route(use_kernel: bool) -> str:
    return "auto" if use_kernel else "ref"


def _compact(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Integers of at most ``bits`` bits in the narrowest container."""
    if bits <= 8:
        return q.to(torch.int8)
    return q.to(torch.int16) if bits <= 16 else q


# ---------------------------------------------------------------------------
# shared-rule quantizers (the exact statistics serving uses)
# ---------------------------------------------------------------------------

def quantize_weights(kernel: torch.Tensor, w_bits: int):
    """[d_in, d_out] float -> (q int32 [d_in, d_out], scale f32 [d_out]).

    Per-output-channel symmetric — identical statistics to
    ``models/quantized.pack_linear_sdv`` (amax over the reduction
    axis)."""
    kf = kernel.to(torch.float32)
    amax = kf.abs().amax(dim=0)
    scale = quantizer.symmetric_scale(amax, w_bits)
    q = quantizer.symmetric_qvalues(kf, scale, w_bits).to(torch.int32)
    return q, scale.to(torch.float32)


def quantize_acts(x: torch.Tensor, a_bits: int):
    """[..., K] float -> (q int32, scale f32 [..., 1]) — per-row
    symmetric, identical to the serving container's dynamic activation
    quantization."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xs = quantizer.symmetric_scale(amax, a_bits)
    xq = quantizer.symmetric_qvalues(xf, xs, a_bits).to(torch.int32)
    return xq, xs


# ---------------------------------------------------------------------------
# STE dense (SDV GEMM datapath)
# ---------------------------------------------------------------------------

def _dense_int_forward(x, kernel, w_bits, a_bits, plan, use_kernel):
    """The integer-decode forward both modes share: exact int32 GEMM
    of the quantized operands, dequantized by the two scales.  Returns
    (y f32, xq, xs, qw, sw)."""
    xq, xs = quantize_acts(x, a_bits)
    qw, sw = quantize_weights(kernel, w_bits)
    if plan is not None:
        words = ops.prepare_sdv_weights(qw.T, plan)
        y_int = ops.packed_matmul(xq, words, plan=plan,
                                  m=kernel.shape[-1],
                                  mode=_route(use_kernel))
    else:
        y_int = ref._exact_int_matmul(xq, qw)
    y = y_int.to(torch.float32) * xs * sw[None, :]
    return y, xq, xs, qw, sw


class _STEDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, w_bits, a_bits, plan, use_kernel):
        y, xq, xs, qw, sw = _dense_int_forward(x, kernel, w_bits, a_bits,
                                               plan, use_kernel)
        ctx.save_for_backward(_compact(xq, a_bits), xs,
                              _compact(qw, w_bits), sw)
        ctx.dtypes = (x.dtype, kernel.dtype)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, xs, qw, sw = ctx.saved_tensors
        x_dtype, k_dtype = ctx.dtypes
        gf = g.to(torch.float32)
        # straight-through: quantizers are identity in the backward
        # pass, so these are the plain matmul gradients at the
        # fake-quant point x_fq = xq * xs, w_fq = qw * sw
        w_fq = qw.to(torch.float32) * sw[None, :]
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (gf @ w_fq.T).to(x_dtype)
        if ctx.needs_input_grad[1]:
            x_fq = xq.to(torch.float32) * xs
            gw = (x_fq.reshape(-1, x_fq.shape[-1]).T
                  @ gf.reshape(-1, gf.shape[-1])).to(k_dtype)
        return gx, gw, None, None, None, None


def ste_dense(x: torch.Tensor, kernel: torch.Tensor, w_bits: int,
              a_bits: int, plan: Optional[SDVPlan] = None,
              use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Fake-quant dense layer: x [..., d_in] @ kernel [d_in, d_out].

    Forward: exact packed integer GEMM (``plan`` given) or the integer
    reference product (``plan=None``) — bit-identical.  Backward: the
    straight-through surrogate d(fq(x) @ fq(w)).  ``use_kernel``
    defaults to whether ``x`` lies on the card."""
    return _STEDense.apply(x, kernel, w_bits, a_bits, plan,
                           _use_kernel_default(use_kernel, x.device))


# ---------------------------------------------------------------------------
# STE conv2d (BSEG datapath)
# ---------------------------------------------------------------------------

def _conv_int_forward(x, w, w_bits, a_bits, plan, use_kernel):
    """Exact integer conv forward shared by both modes.

    Weights: per-output-channel symmetric over (c_in, kh, kw).
    Activations: min/max asymmetric to the unsigned ``a_bits`` domain
    with the mid-domain zero point (Eqs. 9/10) — the serving
    ``bseg_conv_apply`` statistics.  ``packed_conv2d`` returns the
    exact signed-domain correlation on every route, so packed and
    reference decode agree bitwise."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=(1, 2, 3), keepdim=True)
    sw = quantizer.symmetric_scale(amax, w_bits)
    qw = quantizer.symmetric_qvalues(wf, sw, w_bits).to(torch.int32)

    xf = x.to(torch.float32)
    lo = torch.min(xf)
    hi = torch.max(xf)
    xs = quantizer.asymmetric_scale(lo, hi, a_bits)
    zp = quantizer.asymmetric_zero_point(a_bits)
    xq_u = quantizer.asymmetric_qvalues(xf, lo, xs, a_bits)
    xq = (xq_u - zp).to(torch.int32)             # signed datapath input

    if plan is not None:
        y_int = ops.packed_conv2d(xq.to(torch.int8), qw, plan=plan,
                                  zero_point=zp, mode=_route(use_kernel))
    else:
        y_int = ref.conv2d_int_ref(xq, qw)
    # x ~= lo + xs * (xq + zp);  sum w x ~= sw * xs * y_int
    #                                      + (lo + xs*zp) * sw * tap_sum
    tap_sum = torch.sum(qw, dim=(1, 2, 3)).to(torch.float32)   # [C_out]
    sw_c = sw[:, 0, 0, 0]                                      # [C_out]
    y = sw_c * xs * y_int.to(torch.float32) \
        + (lo + xs * zp) * sw_c * tap_sum
    x_fq = lo + xs * xq_u                        # fake-quant activations
    w_fq = qw.to(torch.float32) * sw
    return y, x_fq, w_fq


def _conv_float(x, w):
    """Float stride-1 'same' conv with the oracle's layout (NHWC x
    [C_out, C_in, kh, kw]) — the STE surrogate the backward
    differentiates."""
    kh, kw = w.shape[2], w.shape[3]
    groups = x.shape[-1] // w.shape[1]
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=(kh // 2, kw // 2),
                 groups=groups)
    return y.permute(0, 2, 3, 1)


class _STEConv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, w_bits, a_bits, plan, use_kernel):
        y, x_fq, w_fq = _conv_int_forward(x, w, w_bits, a_bits, plan,
                                          use_kernel)
        ctx.save_for_backward(x_fq, w_fq)
        ctx.dtypes = (x.dtype, w.dtype)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x_fq, w_fq = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        cudnn = torch.backends.cudnn
        with torch.enable_grad(), cudnn.flags(
                enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                deterministic=cudnn.deterministic, allow_tf32=False):
            xr = x_fq.detach().requires_grad_(True)
            wr = w_fq.detach().requires_grad_(True)
            gx, gw = torch.autograd.grad(_conv_float(xr, wr), (xr, wr),
                                         g.to(torch.float32))
        return gx.to(x_dtype), gw.to(w_dtype), None, None, None, None


def ste_conv2d(x: torch.Tensor, w: torch.Tensor, w_bits: int, a_bits: int,
               plan: Optional[BSEGPlan] = None,
               use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Fake-quant stride-1 'same' conv2d: x [B, H, W, C_in] against
    taps [C_out, C_in, kh, kw], forward on the BSEG packed datapath;
    ``use_kernel`` defaults to whether ``x`` lies on the card."""
    return _STEConv2d.apply(x, w, w_bits, a_bits, plan,
                            _use_kernel_default(use_kernel, x.device))


# ---------------------------------------------------------------------------
# the QAT container + params walk
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QATLinear:
    """Float master kernel trained through the STE packed forward.

    ``kernel`` [..., d_in, d_out] is the only tree leaf — gradients and
    optimizer state stay float; quantization/packing happens fresh
    inside each forward (the QAT point).  ``plan=None`` runs the
    integer-decode reference forward (bit-identical); a plan routes
    the GEMM through ``packed_matmul`` on that plan's datapath.  A
    stacked layer tensor keeps its [L, d_in, d_out] leading axis —
    ``layer(i)`` slices it off (the same pattern as ``SDVLinear``).
    ``use_kernel=None`` resolves from the input's device each call."""
    kernel: torch.Tensor
    w_bits: int
    a_bits: int
    plan: Optional[SDVPlan] = None
    use_kernel: Optional[bool] = None

    def qat_apply(self, x: torch.Tensor) -> torch.Tensor:
        return ste_dense(x, self.kernel, self.w_bits, self.a_bits,
                         self.plan, self.use_kernel)

    def layer(self, i: int) -> "QATLinear":
        return dataclasses.replace(self, kernel=self.kernel[i])


register_container(QATLinear, ("kernel",))


def is_qat(x) -> bool:
    return isinstance(x, QATLinear)


def qat_params(params: Any, w_bits: int = 4, a_bits: int = 8,
               min_size: int = 1 << 16,
               precision: Optional[Dict[str, Tuple[int, int]]] = None,
               plan_policy: str = "default",
               plan_cache: Optional[str] = None,
               rows: Optional[int] = None,
               use_kernel: Optional[bool] = None) -> Any:
    """Wrap every packable kernel leaf in a ``QATLinear``.

    Mirrors ``models/quantized.serve_params``'s walk exactly — same
    leaf names, same stacked-container and skip rules, same lm_head
    top-level case — so QAT fake-quantizes precisely the layers the
    export will pack.  ``precision`` overrides (w_bits, a_bits) per
    leaf path (the ``bitsearch`` output); ``plan_policy`` mirrors
    serving: ``"default"`` trains on the integer-decode reference
    forward (plan=None — bit-identical arithmetic, no packing cost
    per step), ``"auto"``/``"cache"`` resolve a packed plan per layer
    through the planner so the forward runs the packed dispatch.
    ``use_kernel`` (default: whether the kernel lies on the card) is
    kept on each container.

    Non-destructive: the wrapped tree shares the float kernels with
    ``params`` — unwrap with ``float_params`` for checkpoint/export.
    """
    from ...models.quantized import (_QUANT_LEAF_NAMES, _SKIP_CONTAINERS,
                                     _stacked_leading_axis,
                                     PLANNER_DECODE_ROWS)
    if plan_policy not in ("default", "auto", "cache"):
        raise ValueError(f"unknown plan policy {plan_policy!r}")
    if rows is None:
        rows = PLANNER_DECODE_ROWS
    precision = precision or {}

    planner_ctx = None
    if plan_policy != "default":
        from ... import planner as _planner
        cache = _planner.PlanCache.load(plan_cache) \
            if plan_policy == "cache" else None
        planner_ctx = {"mod": _planner, "cache": cache, "memo": {}}

    def layer_plan(name, v, wb, ab):
        if planner_ctx is None:
            return None
        mod = planner_ctx["mod"]
        layer = mod.matmul_spec(name, rows, v.shape[-2], v.shape[-1],
                                w_bits=wb, a_bits=ab)
        key = layer.key()
        if key not in planner_ctx["memo"]:
            choice = None
            if planner_ctx["cache"] is not None:
                choice = planner_ctx["cache"].get_choice(layer)
            if choice is None:
                choice = mod.choose_plan(layer)
                if planner_ctx["cache"] is not None:
                    planner_ctx["cache"].put_choice(choice, source="qat")
            planner_ctx["memo"][key] = choice
        return planner_ctx["memo"][key].plan

    def wrap(v, path):
        wb, ab = precision.get(path, (w_bits, a_bits))
        return QATLinear(kernel=v, w_bits=wb, a_bits=ab,
                         plan=layer_plan(path, v, wb, ab),
                         use_kernel=_use_kernel_default(use_kernel,
                                                        v.device))

    def walk(tree, name):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            path = f"{name}/{k}" if name else k
            if k in _SKIP_CONTAINERS:
                out[k] = v
            elif isinstance(v, dict):
                out[k] = walk(v, path)
            elif k in _QUANT_LEAF_NAMES and isinstance(v, torch.Tensor) \
                    and (v.ndim == 2
                         or (v.ndim == 3 and _stacked_leading_axis(path))) \
                    and v.numel() >= min_size:
                out[k] = wrap(v, path)
            else:
                out[k] = v
        return out

    out = walk(params, "")
    if isinstance(out, dict) and "lm_head" in out \
            and not is_qat(out["lm_head"]) \
            and getattr(out["lm_head"], "ndim", 0) == 2:
        out["lm_head"] = wrap(out["lm_head"], "lm_head")
    if planner_ctx is not None and planner_ctx["cache"] is not None:
        planner_ctx["cache"].save()
    return out


def float_params(params: Any) -> Any:
    """Unwrap ``QATLinear`` containers back to the float kernel tree
    (the checkpoint/export representation)."""
    def unwrap(t):
        if is_qat(t):
            return t.kernel
        if isinstance(t, dict):
            return {k: unwrap(v) for k, v in t.items()}
        return t
    return unwrap(params)


def count_qat_layers(params: Any) -> int:
    def walk(t):
        if is_qat(t):
            return 1
        if isinstance(t, dict):
            return sum(walk(v) for v in t.values())
        return 0
    return walk(params)
