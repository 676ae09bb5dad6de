"""Lane packing, packed-matmul and packed-conv2d dispatch — torch port
of ``repro.kernels.ops``.

``pack_weights`` / ``unpack_weights`` are the memory-packed storage
layout (kernels B6 / B7, ``kernels/packbits``): 32/w w-bit fields per
int32 lane word; ``unpack_dequant`` is B7 fused with the scale, trim and
cast of ``materialize`` (the serving path); ``quant_matmul`` is kernel
B5 on those words.

Dispatch table for ``packed_matmul`` (mode -> kernel -> constraints):

  mode           kernel                      weight format      constraints
  -------------  --------------------------  -----------------  ------------------------------
  sdv_matmul     kernels/sdv_matmul (B2,     SDV storage words  integer x; ``plan`` given;
                 csrc/sdv.cu GEMM; at        [K, G] int32, or   ``plan.spec.exact_wrap``;
                 WGMMA_MIN_ROWS and up on    [2, K, G] limb     rows > GEMV_MAX_ROWS in auto
                 single-limb words within    planes
                 8 bits and one-byte x
                 csrc/sdv_wgmma.cu,
                 ``sdv_matmul.takes_wgmma``)
  sdv_matvec     kernels/sdv_matvec (B1,     same               same word gates as sdv_matmul;
                 csrc/sdv.cu GEMV)                              signed-element storage only;
                                                                rows <= GEMV_MAX_ROWS in auto
  quant_matmul   kernels/quant_matmul (B5,   lane words         float x; no ``plan`` (memory
                 csrc/quant_matmul.cu:       [K, N/(32/w)]      packing only); ``scale`` and
                 dequant in-kernel, f32 sum) int32 + scale      ``w_bits`` given
  ref            plain product of the        either             always available; selected in
                 decoded words (exact on                        auto when ``use_kernel`` is
                 the SDV words, float32 on                      False, the datapath is not
                 the lane words)                                exact-wrap, or a hand-built
                                                                plan's layout overruns its word

Dispatch table for ``packed_conv2d`` (mode -> kernel -> constraints):

  mode           kernel                      constraints
  -------------  --------------------------  ------------------------------
  bseg_conv2d    kernels/bseg_conv2d (B3,    integer x; BSEG ``plan`` on
                 csrc/bseg.cu: one block     any datapath (kappa int32,
                 per output row and channel  float32 on FP32M, or [2, ...]
                 tile, a carry chain per     limb planes on DSP48E2/
                 thread, shared row          DSP58); stride 1, 'same'
                 accumulator)                pad: odd kh and kw;
                                             ``plan.w_i <= 7``
  bseg_conv1d    kernels/bseg_conv1d (B4,    depthwise shape (C_in == 1,
                 csrc/bseg1d.cu: a carry     kh == 1); 'same' pad along
                 chain per thread, n_i       W through ``bseg_conv1d``;
                 samples per wide multiply)  same word gates as bseg_conv2d
  im2col         kernels/sdv_matmul (B2)     integer x; patches unfolded
                 via ``packed_matmul`` (SDV  in torch, compute on the SDV
                 plan derived from the BSEG  datapath (exact-wrap words
                 widths, or an ``sdv_plan``  only); odd kh and kw
                 override)
  ref            plain exact integer conv    always available; selected
                 (``ref.conv2d_int_ref``)    in auto when ``use_kernel``
                                             is False, a hand-built
                                             plan's accumulation overruns
                                             its word, or ``plan.w_i > 7``

``mode="auto"`` routes ref-conditions -> bseg_conv1d (depthwise shape)
-> im2col (1x1 kernels on single-limb-word datapaths) -> bseg_conv2d
(everything else, including 1x1 on fp32m / dsp48e2 / dsp58 words).

The route tables and their ``explain=True`` reason strings are the JAX
package's, word for word.  ``packed_matmul`` and ``packed_conv2d``
always route as the JAX package does with ``use_kernel=True``, on every
device: on a CPU tensor the kernel routes run their kernel's plain
version (every integer route is exact, so the integers are the same
either way; the memory-packed route sums float32 products, in another
order on the card than on the CPU).

``bseg_conv1d`` is the causal depthwise short conv of the SSM/Griffin
blocks (the ``BSEGConv`` serving container) on kernel B4;
``select_conv1d_route`` is its route, with the JAX package's reasons.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import bseg as core_bseg
from ..core import limbs
from ..core.datapath import BSEGPlan, SDVPlan, plan_sdv
from ..core.signed_split import pack_unsigned, split_signed
from ..tracing import spanned
from . import bseg_common, packbits, ref
from . import bseg_conv1d as bseg1d_kernel
from . import bseg_conv2d as bseg2d_kernel
from . import quant_matmul as qmm_kernel
from . import sdv_matmul as sdvmm_kernel
from . import sdv_matvec as sdvmv_kernel


# ---------------------------------------------------------------------------
# packbits
# ---------------------------------------------------------------------------

def pack_weights(w_int: torch.Tensor, *, w: int) -> torch.Tensor:
    """Dense [m, n] ints -> [m, n/(32/w)] int32 lane words (kernel B6;
    the values cross as int8, as in the reference's kernel route)."""
    return packbits.pack_words(w_int.to(torch.int8).contiguous(), w=w)


def unpack_weights(packed: torch.Tensor, *, w: int) -> torch.Tensor:
    """[m, nw] int32 lane words -> [m, nw*(32/w)] int8, sign-extended
    (kernel B7)."""
    return packbits.unpack_words(packed.contiguous(), w=w)


def unpack_dequant(packed: torch.Tensor, scale: torch.Tensor, *, w: int,
                   d_out: int, rows_per_scale: int,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """[m, nw] int32 lane words and scales [..., n] (one row of n = nw *
    (32/w) column scales per group of ``rows_per_scale`` rows) -> [m,
    d_out] ``dtype``: sign-extended fields times their scale, trimmed
    and cast in one pass (kernel B7 fused with the dequant)."""
    return packbits.unpack_dequant(
        packed.contiguous(), scale.reshape(-1, scale.shape[-1]).contiguous(),
        w=w, d_out=d_out, rows_per_scale=rows_per_scale, dtype=dtype)


# ---------------------------------------------------------------------------
# quant_matmul  (packed_memory execution mode)
# ---------------------------------------------------------------------------

def quant_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                 scale: torch.Tensor, *, w: int) -> torch.Tensor:
    """x [m, k] @ dequant(w_packed [k, n/(32/w)]) -> [m, n] f32 (kernel
    B5).  Activations other than bf16/f32 are widened to float32 first,
    as the reference's kernel does inside."""
    if x.dtype not in qmm_kernel.X_DTYPES:
        x = x.to(torch.float32)
    return qmm_kernel.quant_matmul(
        x.contiguous(), w_packed.contiguous(),
        scale.reshape(-1).to(torch.float32).contiguous(), w=w)


@spanned("repro_torch.qat.pack")
def prepare_sdv_weights(w_int: torch.Tensor, plan) -> torch.Tensor:
    """[M, K] ints (w_a-bit, signedness per ``plan.signed_a``) -> [K, G]
    int32 storage words, or [2, K, G] int32 limb planes for the wide
    words (``bseg_common.sdv_word_spec``).

    Signed layout: sign-sliced remainder fields (D) in the low
    ``plan.packed_width`` bits, the n sign bits parked above — the two
    pre-adder operands in one word.  Unsigned layout: the values sit
    directly in their lanes (no pre-adder needed).
    """
    m, k = w_int.shape
    n = plan.n
    g = -(-m // n)
    wp = torch.nn.functional.pad(w_int.to(torch.int64), (0, 0, 0, g * n - m))
    wp = wp.reshape(g, n, k).transpose(1, 2)                 # [G, K, n]
    if plan.signed_a:
        r, s = split_signed(wp, plan.w_a)
        word = pack_unsigned(r, plan.w_a, plan.lane) \
            | (pack_unsigned(s, 1, 1) << plan.packed_width)
    else:
        word = pack_unsigned(wp, plan.w_a, plan.lane)
    word = word.T.contiguous()                               # [K, G]
    if bseg_common.sdv_word_spec(plan).limbs == 2:
        return limbs.to_planes(word)                         # [2, K, G]
    return limbs.lo32(word)


def sdv_matvec(x_q: torch.Tensor, w_words: torch.Tensor, *, plan,
               m: int) -> torch.Tensor:
    """Batched exact integer GEMV through the SDV datapath (kernel B1).

    x_q: [B, K] int activations, B <= 8; w_words from
    ``prepare_sdv_weights``; returns [B, m] int32.
    """
    lanes = sdvmv_kernel.sdv_matvec(x_q.to(torch.int32).T.contiguous(),
                                    w_words, plan=plan)
    return lanes.reshape(x_q.shape[0], -1)[:, :m]


#: ``mode="auto"`` routes row counts up to this through the GEMV kernel;
#: anything larger takes the GEMM kernel.
GEMV_MAX_ROWS = sdvmm_kernel.GEMV_MAX_ROWS

_PACKED_MODES = ("auto", "sdv_matmul", "sdv_matvec", "quant_matmul", "ref")


def _matmul_word_gate(plan) -> Optional[str]:
    """Why the SDV GEMM/GEMV kernels cannot represent this plan's word,
    or ``None`` when they can: a hand-built plan whose storage layout
    (packed field + parked sign bits) overruns its own datapath word."""
    layout_bits = bseg_common.sdv_layout_bits(plan)
    if layout_bits > plan.spec.w_word:
        return (f"plan overruns the {plan.spec.name} storage word: "
                f"packed field + parked sign bits = {layout_bits} bits "
                f"> w_word={plan.spec.w_word}")
    return None


def select_packed_route(rows: int, *, plan=None, use_kernel: bool = True,
                        mode: str = "auto", explain: bool = False):
    """Pick the kernel for a packed matmul (the module-docstring table).

    A pure function of (batch rows, plan, kernel switch), so the routing
    is testable without running any kernel.  With ``explain=True``
    returns ``(route, reason)``; the reason strings are the JAX
    package's (its planner cost model reads them).
    """
    def _r(route: str, reason: str):
        return (route, reason) if explain else route

    if mode not in _PACKED_MODES:
        raise ValueError(f"unknown packed_matmul mode {mode!r}")
    if mode in ("sdv_matmul", "sdv_matvec"):
        if plan is None:
            raise ValueError(f"mode {mode!r} needs an SDVPlan")
        if not plan.spec.exact_wrap:
            raise ValueError(
                f"mode {mode!r} needs exact-wrap arithmetic; datapath "
                f"{plan.spec.name} rounds (fp32)")
        gate = _matmul_word_gate(plan)
        if gate is not None:
            raise ValueError(f"mode {mode!r}: {gate}")
        if mode == "sdv_matvec" and not plan.signed_a:
            raise ValueError(
                "the GEMV kernel stores signed elements only (parked "
                "sign bits); use sdv_matmul for unsigned plans")
        return _r(mode, "explicitly requested")
    if mode == "quant_matmul":
        if plan is not None:
            raise ValueError(
                "mode 'quant_matmul' takes memory-packed lane words, "
                "not an SDV plan")
        return _r(mode, "explicitly requested")
    if mode == "ref":
        return _r(mode, "explicitly requested")
    # --- auto ---
    if plan is None:
        if use_kernel:
            return _r("quant_matmul",
                      "no SDV plan: memory-packed lane words")
        return _r("ref", "no Pallas backend (use_kernel=False)")
    if not use_kernel:
        return _r("ref", "no Pallas backend (use_kernel=False)")
    if not plan.spec.exact_wrap:
        return _r("ref", f"datapath {plan.spec.name} rounds (fp32): "
                         "SDV spill-over tracking is invalid")
    gate = _matmul_word_gate(plan)
    if gate is not None:
        return _r("ref", gate)
    if rows <= GEMV_MAX_ROWS and plan.signed_a:
        return _r("sdv_matvec",
                  f"{rows} rows <= GEMV_MAX_ROWS={GEMV_MAX_ROWS}: "
                  "decode-micro-batch GEMV blocks")
    if rows <= GEMV_MAX_ROWS:
        return _r("sdv_matmul",
                  "unsigned elements: the GEMV kernel stores signed "
                  "elements only")
    return _r("sdv_matmul",
              f"{rows} rows > GEMV_MAX_ROWS={GEMV_MAX_ROWS}: "
              "blocked batched GEMM")


def sdv_operand_dtype(rows: int, w: torch.Tensor, plan) -> torch.dtype:
    """The integer container in which ``packed_matmul(plan=plan)`` hands
    ``rows`` rows of activations against the words ``w`` to their kernel
    as they are, for a quantizer to cast to once: one byte where B2 runs
    on its wgmma kernel (``sdv_matmul.takes_wgmma``), else int32."""
    if sdvmm_kernel.takes_wgmma(rows, w.shape[-1], plan):
        return sdvmm_kernel.byte_dtype(plan)
    return torch.int32


def packed_matmul(x: torch.Tensor, w: torch.Tensor, *, plan=None,
                  m: Optional[int] = None,
                  scale: Optional[torch.Tensor] = None,
                  w_bits: Optional[int] = None,
                  mode: str = "auto") -> torch.Tensor:
    """Batched packed matmul with kernel dispatch.

    Args:
      x: activations ``[..., K]`` — integer (within ``plan.w_b`` bits)
        for the SDV routes, float for the memory-packed route.
      w: SDV storage words ``[K, G]`` / ``[2, K, G]`` when ``plan`` is
        given, else memory-packed lane words ``[K, N/(32/w_bits)]``.
      plan: SDV lane plan; ``None`` selects the memory-packed side of
        the table.
      m: real output-channel count (trims the ``G*n`` lane padding, or
        the lane words' column padding); defaults to all lanes.
      scale / w_bits: dequantization scale ``[N]`` and element width —
        required by the memory-packed route only.
      mode: a row of the dispatch table, or ``"auto"``.

    Returns:
      ``[..., M]`` — int32 (exact) on the SDV/ref integer routes, f32
      on the memory-packed route.
    """
    batch_shape, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    route = select_packed_route(x2.shape[0], plan=plan, mode=mode)
    if plan is None:  # memory-packed lane words (kernel B5 or plain)
        if scale is None or w_bits is None:
            raise ValueError(f"route {route!r} needs scale and w_bits")
        if route == "quant_matmul":
            y = quant_matmul(x2, w, scale, w=w_bits)
        else:
            y = ref.quant_matmul_ref(
                x2, ref.unpack_words_ref(w, w=w_bits), scale)
        y = y if m is None else y[:, :m]
        return y.reshape(batch_shape + y.shape[-1:])
    if x.dtype.is_floating_point or x.dtype.is_complex:
        raise ValueError(
            f"route {route!r} needs integer activations within "
            f"plan.w_b={plan.w_b} bits, got {x.dtype}")
    g = w.shape[-1]
    m = g * plan.n if m is None else m
    if route == "ref":
        w_int = ref.sdv_unpack_words_ref(w, plan=plan)       # [K, M_pad]
        y = ref.sdv_matmul_ref(x2, w_int.T)[:, :m]
        return y.reshape(batch_shape + (m,))
    if route == "sdv_matvec":
        y = sdv_matvec(x2, w, plan=plan, m=m)
        return y.reshape(batch_shape + (m,))
    if x2.dtype not in sdvmm_kernel.operand_dtypes(plan):
        x2 = x2.to(torch.int32)
    lanes = sdvmm_kernel.sdv_matmul(x2.contiguous(), w, plan=plan)  # [R, G, n]
    y = lanes.reshape(x2.shape[0], -1)[:, :m]
    return y.reshape(batch_shape + (m,))


# ---------------------------------------------------------------------------
# packed_conv2d  (dispatch layer — see the module docstring table)
# ---------------------------------------------------------------------------

_CONV_MODES = ("auto", "bseg_conv2d", "bseg_conv1d", "im2col", "ref")


def _conv_word_gate(plan: BSEGPlan) -> Optional[str]:
    """Why the BSEG conv kernels cannot represent this plan's word, or
    ``None`` when they can: a hand-built plan whose biased accumulation
    word overruns the accumulator (``plan_bseg`` refuses to dimension
    these)."""
    if plan.n_lanes * plan.lane > plan.spec.w_word:
        return (f"plan overruns the {plan.spec.name} accumulator word: "
                f"{plan.n_lanes} lanes x L={plan.lane} > "
                f"w_word={plan.spec.w_word} (the top lane's guard bias "
                "falls off the word)")
    return None


def _sdv_words_int32(spec) -> bool:
    """True when the SDV GEMM stores this datapath's words in a single
    int32 limb — the *auto* route's preference for the im2col GEMM."""
    return spec.exact_wrap and spec.w_word <= 32


def prepare_bseg_conv2d(w_int: torch.Tensor, plan: BSEGPlan):
    """[C_out, C_in, kh, kw] signed taps -> (packed kernel-row factors
    in the plan's transport layout, [C_out] int32 tap sums).

    Single-limb plans store [G, kh, C_in, C_out] words (int32, or
    float32 on FP32M); wide plans store [2, G, kh, C_in, C_out] int32
    limb planes.  Each kernel row of each (C_out, C_in) pair packs its
    kw taps into ceil(kw/n_k) groups, reversed through the pre-adder;
    the tap sums feed the zero-point correction.
    """
    c_out, c_in, kh, kw = w_int.shape
    groups = -(-kw // plan.n_k)
    wp = torch.nn.functional.pad(w_int.to(torch.int64),
                                 (0, groups * plan.n_k - kw))
    kappa = torch.stack(
        [core_bseg.bseg_pack_kernel(wp[..., gi * plan.n_k:
                                       (gi + 1) * plan.n_k], plan)
         for gi in range(groups)])                 # [G, C_out, C_in, kh]
    kappa = kappa.permute(0, 3, 2, 1).contiguous()  # [G, kh, C_in, C_out]
    tap_sum = w_int.to(torch.int32).sum(dim=(1, 2, 3), dtype=torch.int32)
    return _kappa_transport(kappa, plan), tap_sum


def _kappa_transport(kappa: torch.Tensor, plan: BSEGPlan) -> torch.Tensor:
    """Exact int64 factors -> the plan's transport layout: int32 words,
    float32 on FP32M (exact below 2^24), or [2, ...] int32 limb planes
    on the wide words."""
    ws = bseg_common.word_spec(plan)
    if ws.limbs == 2:
        return limbs.to_planes(kappa)
    if ws.dtype == torch.float32:
        return kappa.to(torch.float32)
    return limbs.lo32(kappa)


def prepare_bseg_taps(taps: torch.Tensor, plan: BSEGPlan):
    """[C, n] signed taps -> (packed factors in the plan's transport
    layout, [C] int32 tap sums).

    Single-limb plans store [G, C] words (int32, or float32 on FP32M);
    wide plans store [2, G, C] int32 limb planes.  Tap groups are packed
    reversed through the pre-adder; the tap sums feed the zero-point
    correction.
    """
    n = taps.shape[-1]
    groups = -(-n // plan.n_k)
    tp = torch.nn.functional.pad(taps.to(torch.int64),
                                 (0, groups * plan.n_k - n))
    kappa = torch.stack(
        [core_bseg.bseg_pack_kernel(tp[:, gi * plan.n_k:
                                       (gi + 1) * plan.n_k], plan)
         for gi in range(groups)])                          # [G, C]
    tap_sum = taps.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    return _kappa_transport(kappa, plan), tap_sum


def bseg_conv1d_x_pad(x_q: torch.Tensor, plan: BSEGPlan, *, n_groups: int,
                      n_taps: int, zero_point: int = 0,
                      padding: str = "causal") -> torch.Tensor:
    """B4's input operand: x_q [B, S, C] signed ints moved into the
    unsigned datapath domain (``x + zero_point``) as int8, left-padded
    for ``padding`` and right-padded to what the step schedule reads.
    The pad is signed zero, i.e. the zero point in the unsigned domain
    (the uniform ``zp * sum(taps)`` correction then holds at the
    boundary too); the extra right pad only feeds discarded outputs."""
    if padding not in ("causal", "same"):
        raise ValueError(f"unknown padding {padding!r}")
    b, s, c = x_q.shape
    left = n_taps - 1 if padding == "causal" else (n_taps - 1) // 2
    _, need = bseg_common.schedule(plan, s, n_groups)
    x_pad = torch.full((b, max(s + left, need), c), zero_point,
                       dtype=torch.int8, device=x_q.device)
    x_pad[:, left:left + s] = (x_q.to(torch.int32) + zero_point) \
        .to(torch.int8)
    return x_pad


def bseg_conv1d(x_q: torch.Tensor, kappa: torch.Tensor,
                tap_sum: torch.Tensor, *, plan: BSEGPlan, n_taps: int,
                zero_point: int = 0,
                padding: str = "causal") -> torch.Tensor:
    """Depthwise conv1d on kernel B4: x_q [B, S, C] int (signed;
    ``zero_point`` shifts it to the unsigned datapath domain); returns
    [B, S, C] int32, the exact signed-domain correlation.

    ``padding="causal"`` aligns output s with inputs s-n+1..s (decode
    convs); ``"same"`` centers the window (the conv2d depthwise route).
    """
    n_groups = kappa.shape[-2]
    x_pad = bseg_conv1d_x_pad(x_q, plan, n_groups=n_groups, n_taps=n_taps,
                              zero_point=zero_point, padding=padding)
    y = bseg1d_kernel.bseg_conv1d(x_pad, kappa, plan=plan,
                                  s_out=x_q.shape[1])
    if zero_point:
        y = y - zero_point * tap_sum[None, None, :]
    return y


def _is_depthwise(x_shape, w_shape) -> bool:
    c_out, c_in, kh, _ = w_shape
    return c_in == 1 and kh == 1 and c_out == x_shape[-1]


def select_conv_route(x_shape, w_shape, *, plan: BSEGPlan,
                      use_kernel: bool = True, mode: str = "auto",
                      explain: bool = False):
    """Pick the kernel for a packed conv2d (the module-docstring table).

    A pure function of (activation shape, weight shape, plan, kernel
    switch).  ``x_shape`` is [B, H, W, C_in]; ``w_shape`` is [C_out,
    C_in, kh, kw].  With ``explain=True`` returns ``(route, reason)``;
    the reason strings are the JAX package's (its planner cost model
    reads them).
    """
    def _r(route: str, reason: str):
        return (route, reason) if explain else route

    if mode not in _CONV_MODES:
        raise ValueError(f"unknown packed_conv2d mode {mode!r}")
    c_out, c_in, kh, kw = w_shape
    if x_shape[-1] != c_in and not _is_depthwise(x_shape, w_shape):
        raise ValueError(
            f"activation channels {x_shape[-1]} != weight C_in {c_in}")
    if mode in ("bseg_conv2d", "bseg_conv1d", "im2col"):
        if mode == "im2col":
            if not plan.spec.exact_wrap:
                raise ValueError(
                    "mode 'im2col' computes on the SDV datapath, which "
                    f"needs exact-wrap arithmetic; {plan.spec.name} "
                    "rounds (fp32) — use the bseg kernels instead")
        else:
            gate = _conv_word_gate(plan)
            if gate is not None:
                raise ValueError(f"mode {mode!r}: {gate}")
        if plan.w_i > 7:
            raise ValueError(
                f"mode {mode!r} stages activations in int8: plan.w_i "
                f"must be <= 7, got {plan.w_i}")
        if kh % 2 == 0 or kw % 2 == 0:
            raise ValueError(
                f"mode {mode!r} is stride-1 'same' pad: kh/kw must be "
                f"odd, got {kh}x{kw}")
        if mode == "bseg_conv1d" and not _is_depthwise(x_shape, w_shape):
            raise ValueError(
                "mode 'bseg_conv1d' needs a depthwise shape: C_in == 1, "
                f"kh == 1, C_out == activation channels; got w {w_shape} "
                f"on x {tuple(x_shape)}")
        return _r(mode, "explicitly requested")
    if mode == "ref":
        return _r(mode, "explicitly requested")
    # --- auto ---
    if not use_kernel:
        return _r("ref", "no Pallas backend (use_kernel=False)")
    gate = _conv_word_gate(plan)
    if gate is not None:
        return _r("ref", gate)
    if plan.w_i > 7:
        return _r("ref", f"plan.w_i={plan.w_i} > 7: the conv kernels "
                         "stage activations in int8")
    if kh % 2 == 0 or kw % 2 == 0:
        return _r("ref", f"even kernel {kh}x{kw}: no stride-1 'same' "
                         "pad")
    if _is_depthwise(x_shape, w_shape):
        return _r("bseg_conv1d",
                  f"depthwise shape on the {plan.spec.name} word: "
                  "channels ride the VPU lanes")
    if kh == 1 and kw == 1:
        if _sdv_words_int32(plan.spec):
            return _r("im2col", "1x1 kernel: no spatial reuse -> GEMM "
                                "on the SDV datapath")
        return _r("bseg_conv2d",
                  f"1x1 kernel on the wide {plan.spec.name} word: the "
                  "2-limb SDV GEMM pays extra limb ops per MAC, the "
                  "BSEG kernel runs the wide word natively")
    return _r("bseg_conv2d",
              f"dense kxk conv on the {plan.spec.name} word: one "
              "cross-channel kernel launch")


def select_conv1d_route(plan: BSEGPlan, *, use_kernel: bool = True,
                        explain: bool = False):
    """Route for the *causal* depthwise short conv (``bseg_conv1d``
    called directly, e.g. the ``BSEGConv`` serving container): no
    odd-taps 'same'-pad constraint, only the datapath gates, shared with
    ``select_conv_route``.  The reason strings are the JAX package's."""
    def _r(route: str, reason: str):
        return (route, reason) if explain else route

    if not use_kernel:
        return _r("ref", "no Pallas backend (use_kernel=False)")
    gate = _conv_word_gate(plan)
    if gate is not None:
        return _r("ref", gate)
    if plan.w_i > 7:
        return _r("ref", f"plan.w_i={plan.w_i} > 7: the conv kernels "
                         "stage activations in int8")
    return _r("bseg_conv1d",
              f"causal depthwise short conv on the {plan.spec.name} word")


def _im2col_sdv_plan(plan: BSEGPlan) -> SDVPlan:
    """SDV plan matching the BSEG widths for the im2col route: signed
    w_k-bit taps against signed (w_i+1)-bit activations — wide enough
    for the unsigned w_i datapath domain AND the signed pre-shift
    values, so no zero-point handling is needed on this route."""
    return plan_sdv(plan.spec, plan.w_k, plan.w_i + 1, signed_a=True,
                    signed_b=True, park_sign_bits=True)


def _im2col_patches(x32: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """[B, H, W, C] ints -> [B, H, W, kh*kw*C] 'same'-pad patches."""
    if kh == 1 and kw == 1:
        return x32
    h, w = x32.shape[1:3]
    xp = torch.nn.functional.pad(x32, (0, 0, kw // 2, kw // 2,
                                       kh // 2, kh // 2))
    cols = [xp[:, r:r + h, q:q + w, :]
            for r in range(kh) for q in range(kw)]
    return torch.cat(cols, dim=-1)


def packed_conv2d(x: torch.Tensor, w_int: torch.Tensor, *, plan: BSEGPlan,
                  mode: str = "auto", zero_point: int = 0,
                  sdv_plan: Optional[SDVPlan] = None) -> torch.Tensor:
    """Stride-1 'same'-pad conv2d with kernel dispatch.

    Args:
      x: [B, H, W, C_in] integer activations; ``x + zero_point`` must
        lie in the unsigned datapath domain [0, 2^w_i) (pass 0 when the
        activations are already unsigned, e.g. post-requantization).
      w_int: [C_out, C_in, kh, kw] signed taps within ``plan.w_k`` bits.
      plan: BSEG plan on any supported datapath.
      mode: a row of the dispatch table, or ``"auto"``.
      zero_point: the activations' zero point (bseg_conv2d and
        bseg_conv1d routes).
      sdv_plan: optional SDV plan for the im2col route; defaults to the
        plan derived from the BSEG widths.  An unsigned-multiplier
        override (``signed_b=False``) needs ``zero_point == 0``.

    Returns:
      [B, H, W, C_out] int32 — the exact signed-domain correlation
      (identical to ``ref.conv2d_int_ref`` on every route).
    """
    if x.dtype.is_floating_point or x.dtype.is_complex:
        raise ValueError(
            f"packed_conv2d needs integer activations within "
            f"plan.w_i={plan.w_i} bits (+zero_point), got {x.dtype}")
    if sdv_plan is not None and not sdv_plan.signed_b and zero_point:
        raise ValueError(
            "an unsigned-multiplier sdv_plan needs zero_point == 0: "
            "the im2col route feeds the pre-shift signed activations")
    route = select_conv_route(tuple(x.shape), tuple(w_int.shape),
                              plan=plan, mode=mode)
    b, h, w, c_in = x.shape
    c_out, _, kh, kw = w_int.shape

    if route == "ref":
        return ref.conv2d_int_ref(x, w_int)

    if route == "bseg_conv1d":
        kappa, tap_sum = prepare_bseg_taps(w_int[:, 0, 0, :], plan)
        y = bseg_conv1d(x.reshape(b * h, w, c_in), kappa, tap_sum,
                        plan=plan, n_taps=kw, zero_point=zero_point,
                        padding="same")
        return y.reshape(b, h, w, c_in)

    if route == "im2col":
        if sdv_plan is None:
            sdv_plan = _im2col_sdv_plan(plan)
        patches = _im2col_patches(x.to(torch.int32), kh, kw)
        w2 = w_int.to(torch.int32).permute(0, 2, 3, 1) \
            .reshape(c_out, kh * kw * c_in)
        words = prepare_sdv_weights(w2, sdv_plan)
        return packed_matmul(patches, words, plan=sdv_plan, m=c_out)

    # bseg_conv2d
    x_pad, kappa, tap_sum = bseg_conv2d_operands(x, w_int, plan,
                                                 zero_point)
    y = bseg2d_kernel.bseg_conv2d(x_pad, kappa, plan=plan, h_out=h,
                                  w_out=w)
    if zero_point:
        y = y - zero_point * tap_sum[None, None, None, :]
    return y


def bseg_conv2d_operands(x: torch.Tensor, w_int: torch.Tensor,
                         plan: BSEGPlan, zero_point: int = 0):
    """The bseg_conv2d route's kernel operands: (x_pad [B, H + kh - 1,
    W_pad, C_in] int8, kappa, [C_out] tap sums).

    The activations move into the unsigned domain (``x + zero_point``);
    the boundary pad is signed zero, i.e. the zero point; the right pad
    covers the step schedule (it only feeds discarded outputs)."""
    b, h, w, c_in = x.shape
    kh, kw = w_int.shape[2:]
    kappa, tap_sum = prepare_bseg_conv2d(w_int, plan)
    n_groups = kappa.shape[-4]
    n_steps = -(-(w + plan.n_k - 1) // plan.n_i)
    need = (n_steps - 1) * plan.n_i + (n_groups - 1) * plan.n_k + plan.n_i
    pad_h, pad_w = kh // 2, kw // 2
    x_pad = torch.full((b, h + 2 * pad_h,
                        w + pad_w + max(pad_w, need - (w + pad_w)), c_in),
                       zero_point, dtype=torch.int8, device=x.device)
    x_pad[:, pad_h:pad_h + h, pad_w:pad_w + w] = \
        (x.to(torch.int32) + zero_point).to(torch.int8)
    return x_pad, kappa, tap_sum


def _unpack_bseg_taps(kappa: torch.Tensor, plan: BSEGPlan,
                      n_taps: int) -> torch.Tensor:
    """Recover [C, n] signed taps from packed factors [G, C] (int32, or
    float32 on FP32M) or [2, G, C] limb planes: the lanes hold the
    arithmetic sum, decoded low-to-high with borrow."""
    if bseg_common.word_spec(plan).limbs == 2:
        words = limbs.from_planes(kappa)
    else:
        words = kappa.to(torch.int64)
    lane, half = plan.lane, 1 << (plan.lane - 1)
    segs = []
    for rem in words:
        vals = []
        for i in range(plan.n_k):
            f = (rem >> (i * lane)) & ((1 << lane) - 1)
            v = torch.where(f >= half, f - (1 << lane), f)
            vals.append(v)
            rem = rem - (v << (i * lane))
        segs.append(torch.stack(vals[::-1], dim=-1))        # un-reverse
    return torch.cat(segs, dim=-1)[:, :n_taps].to(torch.int32)
