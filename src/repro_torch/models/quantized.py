"""Quantized, lane-packed serving parameters — torch port of the SDV
half of ``repro.models.quantized``.

``serve_params(compute="sdv")`` rewrites a parameter tree: projection
kernels — 2-D leaves and stacked layer tensors of them — become
``SDVLinear``: w-bit symmetric per-output-channel quantization stored as
SDV words ([K, G], n output channels lane-packed per word), executed
through ``kernels/ops.packed_matmul`` so decode/prefill GEMMs run on the
packed arithmetic datapath (activations are dynamically quantized per
row to ``plan.w_b`` bits).

Not ported yet: memory packing (``compute="memory"``, ``PackedLinear``,
kernels B5-B7), the BSEG short conv (``BSEGConv``, kernels B3/B4) and
the planner's ``plan_policy="auto"/"cache"``; each raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.datapath import INT32, SDVPlan, plan_sdv
from ..kernels import bseg_common, ops, ref
from ..quant import quantizer


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


def materialize(pl: SDVLinear, dtype=torch.bfloat16) -> torch.Tensor:
    """Unpack + dequantize -> [..., d_in, d_out] in ``dtype``."""
    if pl.stacked:
        return torch.stack([materialize(pl.layer(i), dtype)
                            for i in range(pl.words.shape[0])])
    w_int = ref.sdv_unpack_words_ref(pl.words, plan=pl.plan)
    return (w_int[:, :pl.d_out].to(torch.float32)
            * pl.scale[None, :]).to(dtype)


def is_sdv(x) -> bool:
    return isinstance(x, SDVLinear)


_QUANT_LEAF_NAMES = ("kernel", "wi_gate", "wi_up", "wo")
_SKIP_CONTAINERS = ("router", "conv", "proj_patches")
#: top-level containers whose leading axis is the stacked layer axis —
#: a 3-D kernel under one of these is a stack of 2-D GEMMs
_STACKED_CONTAINERS = ("blocks", "groups", "tail", "enc_blocks",
                       "dec_blocks")


def _stacked_leading_axis(path: str) -> bool:
    head = path.split("/", 1)[0]
    return head in _STACKED_CONTAINERS or head.startswith("blocks_dense")


def serve_params(params: Any, bits: int = 4, min_size: int = 1 << 16,
                 compute: str = "memory", act_bits: int = 8,
                 plan_policy: str = "default") -> Any:
    """Rewrite a parameter tree for quantized packed serving.

    ``compute="sdv"`` packs 2-D kernels and stacked layer tensors of
    2-D kernels (a 3-D leaf under ``blocks``, ``groups``, ... packs per
    layer with a shared plan) with at least ``min_size`` elements, and
    the LM head, as ``SDVLinear`` with ``default_sdv_plan(bits,
    act_bits)``.  The reference's default ``compute="memory"`` and the
    planner policies are not ported yet and raise.
    """
    if compute not in ("memory", "sdv"):
        raise ValueError(f"unknown packed compute mode {compute!r}")
    if plan_policy not in ("default", "auto", "cache"):
        raise ValueError(f"unknown plan policy {plan_policy!r}")
    if compute == "memory":
        raise NotImplementedError(
            "compute='memory' (PackedLinear, kernels B5-B7) is not "
            "ported yet; use compute='sdv'")
    if plan_policy != "default":
        raise NotImplementedError(
            f"plan_policy={plan_policy!r} needs the planner, which is "
            "not ported yet")
    plan = default_sdv_plan(bits, act_bits)

    def quantize(v, name):
        if v.ndim == 2 or (v.ndim == 3 and _stacked_leading_axis(name)):
            return pack_linear_sdv(v, plan)
        raise NotImplementedError(
            f"{name}: unstacked {v.ndim}-D kernels keep memory packing "
            "in the reference, which is not ported yet")

    def walk(tree, name):
        out = {}
        for k, v in tree.items():
            path = f"{name}/{k}" if name else k
            if k == "conv":
                raise NotImplementedError(
                    f"{path}: BSEG short convs (kernels B3/B4) are not "
                    "ported yet")
            if k in _SKIP_CONTAINERS:
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
    if "lm_head" in out and not is_sdv(out["lm_head"]):
        out["lm_head"] = quantize(out["lm_head"], "lm_head")
    return out
