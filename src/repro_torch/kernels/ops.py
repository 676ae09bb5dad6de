"""Packed-matmul dispatch — torch port of the matmul half of
``repro.kernels.ops``.

Dispatch table for ``packed_matmul`` (mode -> kernel -> constraints):

  mode           kernel                      weight format      constraints
  -------------  --------------------------  -----------------  ------------------------------
  sdv_matmul     kernels/sdv_matmul (B2,     SDV storage words  integer x; ``plan`` given;
                 csrc/sdv.cu GEMM)           [K, G] int32, or   ``plan.spec.exact_wrap``;
                                             [2, K, G] limb     rows > GEMV_MAX_ROWS in auto
                                             planes
  sdv_matvec     kernels/sdv_matvec (B1,     same               same word gates as sdv_matmul;
                 csrc/sdv.cu GEMV)                              signed-element storage only;
                                                                rows <= GEMV_MAX_ROWS in auto
  ref            plain exact product of      either             always available; selected in
                 the decoded words                              auto when ``use_kernel`` is
                                                                False, the datapath is not
                                                                exact-wrap, or a hand-built
                                                                plan's layout overruns its word

The route table and its ``explain=True`` reason strings are the JAX
package's, word for word.  ``packed_matmul`` always routes as the JAX
package does with ``use_kernel=True``, on every device: on a CPU tensor
the kernel routes run their kernel's plain version (every route is
exact, so the integers are the same either way).  The memory-packed
``quant_matmul`` route (kernels B5-B7) is not ported yet and raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import limbs
from ..core.signed_split import pack_unsigned, split_signed
from . import bseg_common, ref
from . import sdv_matmul as sdvmm_kernel
from . import sdv_matvec as sdvmv_kernel


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


def packed_matmul(x: torch.Tensor, w: torch.Tensor, *, plan=None,
                  m: Optional[int] = None,
                  mode: str = "auto") -> torch.Tensor:
    """Batched packed matmul with kernel dispatch.

    Args:
      x: integer activations ``[..., K]`` within ``plan.w_b`` bits.
      w: SDV storage words ``[K, G]`` / ``[2, K, G]``.
      plan: SDV lane plan (``None`` would select the memory-packed
        route, which is not ported yet).
      m: real output-channel count (trims the ``G*n`` lane padding);
        defaults to all lanes.
      mode: a row of the dispatch table, or ``"auto"``.

    Returns:
      ``[..., M]`` int32 (exact).
    """
    batch_shape, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    route = select_packed_route(x2.shape[0], plan=plan, mode=mode)
    if plan is None:
        raise NotImplementedError(
            f"route {route!r}: memory-packed lane words (quant_matmul, "
            "kernels B5-B7) are not ported yet")
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
    lanes = sdvmm_kernel.sdv_matmul(x2.to(torch.int32).contiguous(), w,
                                    plan=plan)               # [R, G, n]
    y = lanes.reshape(x2.shape[0], -1)[:, :m]
    return y.reshape(batch_shape + (m,))
