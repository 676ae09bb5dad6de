"""Plain float32 reference of the decoder the configurations run (dense,
vlm text stack and moe families), layer by layer.

It follows the equations the port serves, not the port's code: RMSNorm
(eps 1e-6, the scale after the normalisation), rotary embedding on
queries and keys, grouped-query causal softmax attention over K/V kept
as int8 per (position, head), a SwiGLU MLP or a token-choice top-k
mixture of experts with capacity ``ceil(T k 1.25 / E)`` counted over the
T tokens of one call in token order (a choice past its expert's capacity
adds nothing; the kept weights are not renormalised), and a head over
the final norm.

The expert choice is a top-k of a float32 router: the port's bfloat16
activations choose another expert near a tie, and with 32 layers most
tokens meet such a tie somewhere (PERF.md).  So the decode comparison
can take the program's choices (``routes``) and judge them by
themselves: each must lie within a router-logit margin of this
reference's own top-k, and the tokens then go where the program sent
them, weighted, dropped at capacity and computed by this reference.  The projections of attention and of the dense MLP are
packed W-bit x A-bit products (``quant.packed_linear``); the expert
banks and the head are W-bit weights against float activations.  What
the port keeps in bfloat16 (activations, the dequantized banks and
head, the logits) is float32 here.

Weights are drawn again from the seed (``portbench.weights``), one layer
at a time, and quantized by ``quant``'s rule; nothing of the program is
imported or read.  TF32 is off while the reference runs.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator, List

import torch

from .. import weights as W
from . import quant as Q

#: rows of a batch whose attention scores are formed at once
_ROW_BLOCK = 4


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 (TF32 off) for the duration."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, D], pos [B, S]: each half-pair rotated by pos *
    theta^(-i / (D/2))."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = pos[..., None].to(torch.float32) * freq
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Reference:
    """The reference model of ``arch`` (the configuration's port fields)
    at ``weight_bits`` / ``act_bits`` with weights of ``seed``."""

    def __init__(self, arch: dict, *, weight_bits: int, act_bits: int,
                 seed: int, device):
        self.arch, self.wb, self.ab = arch, weight_bits, act_bits
        self.seed, self.device = seed, torch.device(device)
        self.hd = W.head_dim(arch)
        top = W.draw_top(arch, seed, self.device)
        self.embed_table = top["embed"]
        self.ln_f = top["ln_f/scale"]
        self.head = Q.dequantized_weight(top["lm_head"], weight_bits)

    # -- weights ----------------------------------------------------------
    def layers(self) -> Iterator[dict]:
        """Each layer's weights, drawn and quantized in turn."""
        for i in range(self.arch["n_layers"]):
            raw = W.draw_layer(self.arch, self.seed, i, self.device)
            w = {"ln_attn": raw.pop("ln_attn/scale"),
                 "ln_mlp": raw.pop("ln_mlp/scale")}
            for path in list(raw):
                v = raw.pop(path)
                if path == "moe/router/kernel":
                    w[path] = v.to(torch.float32)
                elif path.startswith("moe/"):
                    w[path] = Q.dequantized_weight(v, self.wb)
                else:
                    w[path] = Q.weight_codes(v, self.wb)
            yield w
            del w

    # -- pieces -------------------------------------------------------------
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed_table[tokens.long()].to(torch.float32)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and head: [..., vocab] float32."""
        return (rmsnorm(x, self.ln_f) @ self.head)[..., :self.arch["vocab"]]

    def _proj(self, w: dict, path: str, x: torch.Tensor) -> torch.Tensor:
        codes, scale = w[path]
        return Q.packed_linear(x, codes, scale, self.ab)

    def _attention(self, w, x, pos, prefix):
        """x [B, S, d] at positions pos [B, S]; ``prefix`` (k, v) [B, P,
        KV, hd] float32 of the positions before each row's first, with
        room for the new ones, or None (the rows start at 0)."""
        a = self.arch
        b, s, _ = x.shape
        h, g, hd = a["n_heads"], a["n_kv"], self.hd
        theta = a.get("rope_theta", 10000.0)
        q = rope(self._proj(w, "attn/wq/kernel", x).view(b, s, h, hd), pos,
                 theta)
        k = rope(self._proj(w, "attn/wk/kernel", x).view(b, s, g, hd), pos,
                 theta)
        v = self._proj(w, "attn/wv/kernel", x).view(b, s, g, hd)
        kq, ks = Q.kv_roundtrip(k)
        vq, vs = Q.kv_roundtrip(v)
        k = kq.to(torch.float32) * ks[..., None]
        v = vq.to(torch.float32) * vs[..., None]
        if prefix is None:
            kf, vf = k, v
        else:
            kf, vf = prefix[0].clone(), prefix[1].clone()
            ix = pos.long()[:, :, None, None].expand(b, s, g, hd)
            kf.scatter_(1, ix, k)
            vf.scatter_(1, ix, v)
        kpos = torch.arange(kf.shape[1], device=x.device)
        out = torch.empty((b, s, h * hd), dtype=torch.float32,
                          device=x.device)
        q5 = q.view(b, s, g, h // g, hd)
        for lo in range(0, b, _ROW_BLOCK):
            sl = slice(lo, lo + _ROW_BLOCK)
            sc = torch.einsum("bsgrd,btgd->bsgrt", q5[sl], kf[sl]) \
                / torch.tensor(math.sqrt(hd), device=x.device)
            mask = kpos[None, None, :] <= pos[sl, :, None]
            sc = torch.where(mask[:, :, None, None, :], sc, -1e30)
            p = torch.softmax(sc, dim=-1)
            o = torch.einsum("bsgrt,btgd->bsgrd", p, vf[sl])
            out[sl] = o.reshape(o.shape[0], s, h * hd)
        return self._proj(w, "attn/wo/kernel", out)

    def _moe(self, w, z, routes=None):
        """z [B, S, d]: each column's B tokens are one call (one decode
        step), routed with that call's capacity in row order.  With
        ``routes`` [S, B, k] (the program's expert choices) the tokens go
        where the program sent them, weighted by this reference's own
        router; returns (y, the widest router-logit deficit of a choice
        below this reference's k-th best, 0 without ``routes``)."""
        a = self.arch
        b, s, d = z.shape
        e, k = a["n_experts"], a["top_k"]
        cap = max(1, math.ceil(b * k * 1.25 / e))
        zt = z.transpose(0, 1).reshape(s * b, d)            # call-major
        logits = zt @ w["moe/router/kernel"]
        probs = torch.softmax(logits, dim=-1)
        if routes is None:
            top_p, top_e = torch.topk(probs, k, dim=-1)
            deficit = 0.0
        else:
            top_e = routes.reshape(s * b, k).long()
            top_p = probs.gather(1, top_e)
            kth = logits.topk(k, dim=-1).values[:, -1:]
            deficit = float((kth - logits.gather(1, top_e)).max()
                            .clamp_min(0))
        top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
        onehot = torch.nn.functional.one_hot(top_e.view(s, b * k), e)
        slot = (torch.cumsum(onehot, dim=1) - 1).gather(
            2, top_e.view(s, b * k, 1))[..., 0].reshape(-1)
        keep = slot < cap
        flat_e = top_e.reshape(-1)
        tok = torch.arange(s * b, device=z.device).repeat_interleave(k)
        y = torch.zeros_like(zt)
        for ex in range(e):
            sel = keep & (flat_e == ex)
            rows = tok[sel]
            if rows.numel() == 0:
                continue
            xe = zt[rows]
            hid = silu(xe @ w["moe/wi_gate"][ex]) * (xe @ w["moe/wi_up"][ex])
            y.index_add_(0, rows, (hid @ w["moe/wo"][ex])
                         * top_p.reshape(-1)[sel][:, None])
        return y.view(s, b, d).transpose(0, 1), deficit

    def block(self, w: dict, x: torch.Tensor, pos: torch.Tensor,
              prefix=None, routes=None):
        """One layer: x + attention, then + the FFN, each of its norm.
        Returns (x, the MoE routing deficit: 0 on a dense layer)."""
        x = x + self._attention(w, rmsnorm(x, w["ln_attn"]), pos, prefix)
        z = rmsnorm(x, w["ln_mlp"])
        if self.arch["family"] == "moe":
            y, deficit = self._moe(w, z, routes)
            return x + y, deficit
        gate = self._proj(w, "mlp/wi_gate/kernel", z)
        up = self._proj(w, "mlp/wi_up/kernel", z)
        return x + self._proj(w, "mlp/wo/kernel", silu(gate) * up), 0.0

    # -- the two comparisons ------------------------------------------------
    def prompt_logits(self, prompts: List[torch.Tensor]) -> torch.Tensor:
        """Each prompt (1-D tokens) from position 0; the logits at its
        last position, [N, vocab]."""
        with no_tf32(), torch.no_grad():
            xs = [self.embed(p)[None] for p in prompts]
            pos = [torch.arange(p.numel(), device=self.device)[None]
                   for p in prompts]
            for w in self.layers():
                xs = [self.block(w, x, ps)[0] for x, ps in zip(xs, pos)]
            return torch.cat([self.logits(x[:, -1]) for x in xs])

    def decode_logits(self, tokens: torch.Tensor, start: torch.Tensor,
                      prefix: Callable[[int], tuple], routes=None):
        """tokens [B, n] fed one column a step from positions ``start``
        [B] onwards, on a cache whose layer i is ``prefix(i)`` = (k, v)
        [B, P, KV, hd] float32 (valid below ``start``).  ``routes``, on
        the moe family, is each layer's [n, B, k] expert choices of the
        program (``_moe``).  Returns (every step's logits [B, n, vocab],
        the widest routing deficit over the layers)."""
        with no_tf32(), torch.no_grad():
            x = self.embed(tokens)
            pos = start.long()[:, None] + torch.arange(
                tokens.shape[1], device=self.device)[None]
            deficit = 0.0
            for i, w in enumerate(self.layers()):
                x, d = self.block(w, x, pos, prefix(i),
                                  None if routes is None else routes[i])
                deficit = max(deficit, d)
            return self.logits(x), deficit


def served_gaps(ref_logits: torch.Tensor,
                served: torch.Tensor) -> torch.Tensor:
    """How far each served token's reference logit lies below the
    reference's best at that position (0 where they agree)."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served.long()[..., None])[..., 0]
    return best - got


def widest(gaps: torch.Tensor) -> float:
    """The widest gap; NaN (never within a limit) when any is not
    finite."""
    g = gaps.reshape(-1).to(torch.float64)
    if g.numel() == 0 or not bool(torch.isfinite(g).all()):
        return float("nan")
    return float(g.max())
