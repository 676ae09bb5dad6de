"""Feasible-plan enumeration per layer (paper Eqs. 4 and 7-10) — torch
port of ``repro.planner.enumerate``.

A *layer* is a bitwidth-annotated workload shape (``LayerSpec``); a
*candidate* is an ``SDVPlan`` or ``BSEGPlan`` that the Sec. III
dimensioning rules admit for it.  Enumeration sweeps

  * the datapath (DSP48E2 / DSP58 / INT32 / FP32M),
  * the packing factor (SDV ``n``; BSEG ``n_k x n_i``),
  * guard bits (lane sizes above the Eq. 4 / Eq. 9 minimum — a larger
    lane buys a larger resident low part ``w_l``, cheaper slicing),
  * signedness of the multiplier operand (unsigned activations can
    either use the unsigned domain directly or be treated as signed
    with one extra bit, the ``_im2col_sdv_plan`` trick),

and keeps every plan ``core/datapath.plan_sdv``/``plan_bseg`` accept —
those constructors *are* the Eq. 4/7-10 checks, so an unsatisfiable
(bits, datapath) combination enumerates empty rather than raising.
Whether a candidate ever reaches a kernel (exact_wrap, int32 words,
int8 staging) is the *cost model's* concern, not enumeration's: a plan
that only runs on the plain ref path is feasible, just expensive.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

from ..core.datapath import (BSEGPlan, DATAPATHS, DatapathSpec, SDVPlan,
                             plan_bseg, plan_sdv)

Plan = Union[SDVPlan, BSEGPlan]

#: extra lane bits swept above the minimum lane size
MAX_GUARD_SWEEP = 2
#: BSEG packing-factor sweep bound (density caps out well below this
#: for every >= 2-bit width on every supported datapath)
MAX_BSEG_FACTOR = 8


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer's workload: geometry + bitwidths + signedness.

    ``kind`` selects the geometry fields that matter:

      * ``"matmul"``  — ``rows`` batch rows of a ``[k] @ [k, m]``
        projection (decode/prefill GEMM, or an im2col'd 1x1 conv);
      * ``"conv2d"``  — a stride-1 'same' ``kh x kw`` conv over a
        ``h x w`` frame, ``c_in -> c_out`` channels (batch ``rows``);
      * ``"conv1d"``  — the depthwise causal short conv (SSM/Griffin):
        ``c_in`` channels, ``kw`` taps, nominal sequence ``w``.
    """
    name: str
    kind: str                   # "matmul" | "conv2d" | "conv1d"
    w_bits: int                 # weight element width
    a_bits: int                 # activation element width
    a_signed: bool = True       # activation signedness
    w_signed: bool = True       # weight signedness
    rows: int = 1               # batch rows (matmul) / batch (conv)
    k: int = 0                  # matmul reduction length
    m: int = 0                  # matmul output channels
    h: int = 0
    w: int = 0                  # frame width / conv1d sequence length
    c_in: int = 0
    c_out: int = 0
    kh: int = 1
    kw: int = 1

    def __post_init__(self):
        if self.kind not in ("matmul", "conv2d", "conv1d"):
            raise ValueError(f"unknown layer kind {self.kind!r}")

    @property
    def macs(self) -> int:
        if self.kind == "matmul":
            return self.rows * self.k * self.m
        if self.kind == "conv2d":
            return (self.rows * self.h * self.w * self.c_out
                    * self.c_in * self.kh * self.kw)
        return self.rows * self.w * self.c_in * self.kw      # conv1d

    def key(self) -> str:
        """Stable identity string — the autotune-cache key component."""
        sg = ("s" if self.a_signed else "u") + \
             ("s" if self.w_signed else "u")
        if self.kind == "matmul":
            geo = f"r{self.rows}.k{self.k}.m{self.m}"
        elif self.kind == "conv2d":
            geo = (f"b{self.rows}.{self.h}x{self.w}.{self.c_in}-"
                   f"{self.c_out}.k{self.kh}x{self.kw}")
        else:
            geo = f"b{self.rows}.s{self.w}.c{self.c_in}.t{self.kw}"
        return f"{self.kind}:{geo}:w{self.w_bits}a{self.a_bits}{sg}"


def matmul_spec(name: str, rows: int, k: int, m: int, *, w_bits: int,
                a_bits: int, a_signed: bool = True) -> LayerSpec:
    return LayerSpec(name=name, kind="matmul", rows=rows, k=k, m=m,
                     w_bits=w_bits, a_bits=a_bits, a_signed=a_signed)


def conv2d_spec(name: str, h: int, w: int, c_in: int, c_out: int,
                kh: int, kw: int, *, w_bits: int, a_bits: int,
                rows: int = 1, a_signed: bool = False) -> LayerSpec:
    return LayerSpec(name=name, kind="conv2d", rows=rows, h=h, w=w,
                     c_in=c_in, c_out=c_out, kh=kh, kw=kw,
                     w_bits=w_bits, a_bits=a_bits, a_signed=a_signed)


def conv1d_spec(name: str, channels: int, taps: int, *, w_bits: int,
                a_bits: int, seq: int = 128, rows: int = 1) -> LayerSpec:
    return LayerSpec(name=name, kind="conv1d", rows=rows, w=seq,
                     c_in=channels, c_out=channels, kw=taps,
                     w_bits=w_bits, a_bits=a_bits, a_signed=False)


# ---------------------------------------------------------------------------
# enumeration
# ---------------------------------------------------------------------------

def _multiplier_variants(layer: LayerSpec):
    """(w_b, signed_b) options for the SDV multiplier operand."""
    if layer.a_signed:
        return [(layer.a_bits, True)]
    # unsigned activations: native unsigned domain, or signed with one
    # protection bit (the ops._im2col_sdv_plan trick — zero-point-free)
    return [(layer.a_bits, False), (layer.a_bits + 1, True)]


def enumerate_sdv_plans(layer: LayerSpec,
                        specs: Optional[Sequence[DatapathSpec]] = None,
                        max_guard: int = MAX_GUARD_SWEEP) -> List[SDVPlan]:
    """Every Eq. 4-feasible SDV packing for ``layer``: datapath x
    packing factor n x guard bits x multiplier signedness."""
    out, seen = [], set()
    for spec in (specs if specs is not None else DATAPATHS.values()):
        for w_b, signed_b in _multiplier_variants(layer):
            for guard in range(max_guard + 1):
                try:
                    base = plan_sdv(spec, layer.w_bits, w_b,
                                    signed_a=layer.w_signed,
                                    signed_b=signed_b,
                                    lane=None if guard == 0 else
                                    layer.w_bits + w_b - 1 + guard,
                                    park_sign_bits=layer.w_signed)
                except ValueError:
                    continue
                for n in range(1, base.n + 1):
                    cand = dataclasses.replace(base, n=n)
                    sig = (spec.name, cand.w_a, cand.w_b, cand.lane,
                           cand.n, cand.signed_a, cand.signed_b)
                    if sig not in seen:
                        seen.add(sig)
                        out.append(cand)
    return out


def enumerate_bseg_plans(layer: LayerSpec,
                         specs: Optional[Sequence[DatapathSpec]] = None,
                         max_guard: int = MAX_GUARD_SWEEP) -> List[BSEGPlan]:
    """Every Eq. 7-10-feasible BSEG packing for ``layer``: datapath x
    (n_k, n_i) x guard bits.  The activation operand is the unsigned
    ``a_bits`` datapath domain (Sec. III-D); signed activations shift
    in through a zero point at dispatch, so ``a_signed`` does not
    change the dimensioning."""
    out, seen = [], set()
    for spec in (specs if specs is not None else DATAPATHS.values()):
        for n_k in range(1, MAX_BSEG_FACTOR + 1):
            for n_i in range(1, MAX_BSEG_FACTOR + 1):
                try:
                    base = plan_bseg(spec, layer.w_bits, layer.a_bits,
                                     n_k=n_k, n_i=n_i)
                except ValueError:
                    continue
                cands = [base]
                for guard in range(1, max_guard + 1):
                    try:
                        cands.append(plan_bseg(spec, layer.w_bits,
                                               layer.a_bits, n_k=n_k,
                                               n_i=n_i,
                                               lane=base.lane + guard))
                    except ValueError:
                        continue
                for cand in cands:
                    sig = (spec.name, cand.w_k, cand.w_i, cand.lane,
                           cand.n_k, cand.n_i, cand.w_l)
                    if sig not in seen:
                        seen.add(sig)
                        out.append(cand)
    return out


def enumerate_plans(layer: LayerSpec,
                    specs: Optional[Sequence[DatapathSpec]] = None,
                    max_guard: int = MAX_GUARD_SWEEP) -> List[Plan]:
    """All candidates for a layer.  Matmul layers take SDV plans; conv
    layers take BSEG plans *and* SDV plans (the im2col route — a conv
    with little spatial reuse is a GEMM)."""
    if layer.kind == "matmul":
        return list(enumerate_sdv_plans(layer, specs, max_guard))
    if layer.kind == "conv1d":
        return list(enumerate_bseg_plans(layer, specs, max_guard))
    return (list(enumerate_bseg_plans(layer, specs, max_guard))
            + list(enumerate_sdv_plans(layer, specs, max_guard)))


# ---------------------------------------------------------------------------
# plan (de)serialization — the autotune-cache value format
# ---------------------------------------------------------------------------

def plan_to_dict(plan: Plan) -> dict:
    if isinstance(plan, SDVPlan):
        return {"type": "sdv", "spec": plan.spec.name, "w_a": plan.w_a,
                "w_b": plan.w_b, "lane": plan.lane, "n": plan.n,
                "signed_a": plan.signed_a, "signed_b": plan.signed_b}
    if isinstance(plan, BSEGPlan):
        return {"type": "bseg", "spec": plan.spec.name, "w_k": plan.w_k,
                "w_i": plan.w_i, "lane": plan.lane, "n_k": plan.n_k,
                "n_i": plan.n_i, "w_l": plan.w_l}
    raise TypeError(f"not a plan: {plan!r}")


def plan_from_dict(d: dict) -> Plan:
    spec = DATAPATHS[d["spec"]]
    if d["type"] == "sdv":
        return SDVPlan(spec=spec, w_a=d["w_a"], w_b=d["w_b"],
                       lane=d["lane"], n=d["n"], signed_a=d["signed_a"],
                       signed_b=d["signed_b"])
    if d["type"] == "bseg":
        return BSEGPlan(spec=spec, w_k=d["w_k"], w_i=d["w_i"],
                        lane=d["lane"], n_k=d["n_k"], n_i=d["n_i"],
                        w_l=d["w_l"])
    raise ValueError(f"unknown plan type {d.get('type')!r}")
