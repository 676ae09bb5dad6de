"""Binary Segmentation convolution (paper Sec. III-D, Figs. 2c, 6, 7) —
torch port of ``repro.core.bseg``.

BSEG packs *both* multiplier inputs: n_k kernel taps (reversed) into the
first factor, n_i input samples into the second.  Lane ``p`` of the
product then holds  sum_{i+j=p} K_rev[i] * I[t+j]  — convolution partial
sums computed *inside* the multiplier array (Pan's binary segmentation).

Dataflow (Fig. 6), one kernel group of n_k taps:
  * step t (t advances by n_i):  W = kappa * iota_t + C_t
  * after the add, lanes p < n_i hold *complete* outputs
    o = t - n_k + 1 + p  -> extracted and emitted;
  * remaining lanes carry to the next step:  C_{t+n_i} is the word
    shifted down n_i lanes — on the DSP this is the C-port / cascade.

Guard bits (Eqs. 9/10): each accumulation lane is biased by 2^(L-1) so
lane values stay within [0, 2^L) — no spill-over can occur, in either
direction.  Between steps every carried lane is *sliced* (Fig. 7): the
low w_l bits stay on the datapath, the high part is extracted to fabric
(here: accumulated straight into the output buffer) and replaced by a
fresh guard bias.

Kernels longer than n_k taps split into ceil(n/n_k) groups whose
results combine through an adder tree (Sec. III-D).

Works on every datapath, including FP32M: all lane values stay inside
the exact product budget by construction, so fp32 arithmetic is exact.
The int32 word is carried in int64 and wrapped to 32 bits after each
product and carry (two's complement, as the reference's int32 words
wrap); the DSP48E2/DSP58 words are int64.  ``bseg_conv1d_grouped`` and
``bseg_conv1d`` are the cycle-true oracle (the JAX package's
``lax.scan`` over steps is a loop here), equal to the reference's
outputs bit for bit; the serving path runs kernels B3/B4.
``bseg_pack_kernel`` gives the exact int64 words, which
``kernels.ops.prepare_bseg_conv2d`` narrows to the plan's transport.
"""
from __future__ import annotations

import torch

from .datapath import BSEGPlan
from .signed_split import pack_signed, pack_unsigned


def word_dtype(plan: BSEGPlan) -> torch.dtype:
    """The datapath word's dtype: float32 for FP32M, int32 for words of
    at most 32 bits, int64 for the wide DSP48E2/DSP58 words."""
    if not plan.spec.exact_wrap:
        return torch.float32
    return torch.int32 if plan.spec.w_word <= 32 else torch.int64


def _is_float(dt: torch.dtype) -> bool:
    return dt.is_floating_point


def shift_down(word: torch.Tensor, bits: int) -> torch.Tensor:
    """word >> bits — exact power-of-two divide + floor on the float
    (FP32M) word representation."""
    if _is_float(word.dtype):
        return torch.floor(word / float(2 ** bits))
    return word >> bits


def mod_pow2(word: torch.Tensor, bits: int) -> torch.Tensor:
    """word mod 2^bits — mask on integers, exact float mod on FP32M (the
    operand is a non-negative exact integer below 2^w_word)."""
    if _is_float(word.dtype):
        q = float(2 ** bits)
        return word - torch.floor(word / q) * q
    return word & ((1 << bits) - 1)


def _carrier(plan: BSEGPlan) -> torch.dtype:
    """The dtype the words are computed in: float32 on FP32M, else
    int64 (the int32 word wrapped by ``_wrap``)."""
    return torch.float32 if not plan.spec.exact_wrap else torch.int64


def _wrap(word: torch.Tensor, plan: BSEGPlan) -> torch.Tensor:
    """An int32 word's value mod 2^32, sign-extended in its int64
    carrier; other words as they are."""
    if word_dtype(plan) != torch.int32:
        return word
    return ((word + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def bseg_pack_kernel(taps: torch.Tensor, plan: BSEGPlan) -> torch.Tensor:
    """Pack (reversed) kernel taps [..., n_k] into the first factor via
    the pre-adder (taps are signed).  Returns the exact int64 words."""
    assert taps.shape[-1] == plan.n_k
    return pack_signed(taps.flip(-1), plan.w_k, plan.lane)


def bseg_pack_inputs(window: torch.Tensor, plan: BSEGPlan) -> torch.Tensor:
    """Pack unsigned input samples [..., n_i] into the second factor, in
    the plan's word dtype."""
    assert window.shape[-1] == plan.n_i
    return pack_unsigned(window, plan.w_i, plan.lane).to(word_dtype(plan))


def _bias_word(plan: BSEGPlan, lanes_from: int, lanes_to: int,
               dtype: torch.dtype, device=None) -> torch.Tensor:
    """sum_{p in [lanes_from, lanes_to)} 2^(pL) * 2^(L-1)."""
    val = sum((2 ** (p * plan.lane)) * plan.bias
              for p in range(lanes_from, lanes_to))
    return torch.tensor(float(val) if _is_float(dtype) else val,
                        dtype=dtype, device=device)


def bseg_conv1d_grouped(taps: torch.Tensor, inputs: torch.Tensor,
                        plan: BSEGPlan) -> torch.Tensor:
    """Single-group BSEG pipeline: taps [..., n_k], inputs [..., m]
    (unsigned, within w_i).  Returns the *full* correlation, length
    m - n_k + 1, exact, in the plan's word dtype.

    The loop below is the cycle-true Fig. 6 schedule; batch dims are
    vectorized.
    """
    wdt, cdt = word_dtype(plan), _carrier(plan)
    dev = inputs.device
    n_k, n_i, L = plan.n_k, plan.n_i, plan.lane
    n_lanes = plan.n_lanes
    m = inputs.shape[-1]
    m_out = m - n_k + 1
    assert m_out >= 1

    # steps: emissions at step t cover outputs t-n_k+1 .. t-n_k+n_i,
    # so t must reach m_out - 1 + n_k - 1; steps advance by n_i.
    n_steps = -(-(m_out + n_k - 1) // n_i)
    # inputs consumed at step t: positions t .. t+n_i-1
    pad_in = max(0, n_steps * n_i + n_i - m)
    inputs_p = torch.cat([inputs, inputs.new_zeros(inputs.shape[:-1]
                                                   + (pad_in,))], dim=-1)
    # pre-pack every input window (the BSEG "input generator"):
    span = inputs_p.shape[-1] - n_i + 1
    windows = torch.stack([inputs_p[..., j:j + span] for j in range(n_i)],
                          dim=-1)
    iotas = bseg_pack_inputs(windows, plan).to(cdt)   # [..., positions]
    kappa = _wrap(bseg_pack_kernel(taps, plan), plan).to(cdt)
    batch = kappa.shape

    # output accumulation buffer with margins: writes land at
    # buf[t + p] for product lane p -> output o = t + p - (n_k-1),
    # i.e. buf index = o + n_k - 1; allocate slack for tail lanes.
    buf_len = m_out + n_k - 1 + n_lanes + n_i
    acc = torch.zeros(batch + (buf_len,), dtype=cdt, device=dev)
    # carry word C: lanes [0, n_lanes) biased (low n_k-1 lanes hold
    # resident low parts, the rest fresh bias).
    c = _wrap(_bias_word(plan, 0, n_lanes, cdt, dev), plan).expand(batch)
    bias_top = _bias_word(plan, n_lanes - n_i, n_lanes, cdt, dev)
    lane_scale = [float(2 ** (p * L)) if _is_float(cdt) else 1 << (p * L)
                  for p in range(n_lanes + 1)]

    for t in range(n_steps):
        iota = iotas[..., t * n_i]
        word = _wrap(kappa * iota + c, plan)     # the wide MAC (+C port)
        # --- extract the n_i completed low lanes ------------------------
        out_win = torch.stack(
            [mod_pow2(shift_down(word, p * L), L) - plan.bias
             for p in range(n_i)], dim=-1)       # guard bias removed
        # --- slice carried lanes (Fig. 7): keep w_l bits, extract high --
        hi_vals = []
        lo_word = torch.zeros_like(word)
        for p in range(n_i, n_lanes):
            f = mod_pow2(shift_down(word, p * L), L)
            lo = mod_pow2(f, plan.w_l)
            hi_vals.append((f - lo) - plan.bias)  # tracked in fabric
            # re-biased resident value, shifted down n_i lanes:
            lo_word = lo_word + (lo + plan.bias) * lane_scale[p - n_i]
        # fresh bias for the lanes newly exposed at the top:
        c = _wrap(lo_word + bias_top, plan)
        # --- scatter into the output buffer ----------------------------
        acc[..., t * n_i:t * n_i + n_i] += out_win
        if hi_vals:
            acc[..., t * n_i + n_i:t * n_i + n_lanes] += torch.stack(
                hi_vals, dim=-1)
    # buf index = o + n_k - 1
    return _wrap(acc[..., n_k - 1:n_k - 1 + m_out], plan).to(wdt)


def bseg_conv1d(kernel: torch.Tensor, inputs: torch.Tensor,
                plan: BSEGPlan, *, input_zero_point: int = 0
                ) -> torch.Tensor:
    """Full 1-D correlation  y[o] = sum_q kernel[..., q] inputs[..., o+q]
    through the BSEG datapath, for arbitrary kernel length.

    kernel: [..., n] signed ints within w_k.
    inputs: [..., m]; must be unsigned within w_i, or signed with
      ``input_zero_point`` (the standard zero-point correction —
      y = sum K (I + zp) - zp * sum K — keeps the datapath unsigned as
      the paper's Eqs. 9/10 assume).
    """
    n = kernel.shape[-1]
    m = inputs.shape[-1]
    if input_zero_point:
        inputs = inputs + input_zero_point
    groups = -(-n // plan.n_k)
    pad_k = groups * plan.n_k - n
    kern = torch.cat([kernel, kernel.new_zeros(kernel.shape[:-1]
                                               + (pad_k,))], dim=-1)
    # zero-pad inputs so the (zero-tap-padded) last group stays in range;
    # the padding only ever multiplies zero taps.
    inputs = torch.cat([inputs, inputs.new_zeros(inputs.shape[:-1]
                                                 + (pad_k,))], dim=-1)
    m_out = m - n + 1
    total = None
    for g in range(groups):
        taps = kern[..., g * plan.n_k:(g + 1) * plan.n_k]
        shifted = inputs[..., g * plan.n_k:]
        y_g = bseg_conv1d_grouped(taps, shifted, plan)[..., :m_out]
        total = y_g if total is None else total + y_g      # adder tree
    if input_zero_point:
        corr = input_zero_point * torch.sum(
            kernel.to(total.dtype), dim=-1, keepdim=True)
        total = total - corr
    return total


def bseg_num_multiplies(n_taps: int, m: int, plan: BSEGPlan) -> int:
    """Wide multiplies consumed by one 1-D BSEG conv of ``n_taps`` taps
    over ``m`` inputs (the density / resource accounting)."""
    groups = -(-n_taps // plan.n_k)
    m_out = m - n_taps + 1
    n_steps = -(-(m_out + plan.n_k - 1) // plan.n_i)
    return groups * n_steps
