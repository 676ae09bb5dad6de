"""Speculative decoding on the packed datapath — torch port of
``repro.serving.spec`` (DESIGN.md §5.2).

The paper's density law (Eq. 4) says the wide word fits
``n = 1 + (budget - w_a - 1) // L`` operands, so an aggressively
quantized copy of the same weights packs denser than the serving tier.
A **self-speculation draft** — the target checkpoint re-quantized by
``serve_params`` at forced low bits, no second checkpoint — proposes
``k`` tokens per round, and the target scores all ``k + 1`` positions
in ONE chunked verification wave (``models.verify_step``), accepting
the longest prefix that matches its own greedy argmax.  Shrinking the
activations is what packs denser (the lane width is ``w_a + w_b - 1``):
W4A4 resolves to n = 4 on DSP48E2 against the W4A8 target's n = 3, so
the default draft is W4A4.

* **Exactness.**  Column ``j`` of ``verify_step``'s logits is bit for
  bit the logits of ``j + 1`` sequential ``decode_step``s, and the
  emitted tokens are the *target's* argmax choices, so a speculative
  completion equals plain decode token for token whatever the draft
  proposes; a useless draft costs throughput, never correctness.  The
  verification wave's projections take all ``B x (k+1)`` rows in one
  packed GEMM (kernel B2), exact at any row count; its float ops (norms,
  attention products, the bf16 LM head) gave the decode step's bits at
  the engine's shapes on the H100 too (``scripts/verify_vs_decode.py``;
  ``chip_smoke.py`` checks it on every run).
* **The fork.**  The draft reads the target's own KV cache (the layouts
  are shared) and writes its speculative positions into a fork that is
  discarded after proposing.  The port's model calls write caches in
  place, so the fork is a working cache of the bucket's shape that each
  round overwrites from the target's (``copy_``, no allocation per
  round); the target's cache is never written by the draft.

A round is two device programs, as in the reference: ``draft`` (k
decode steps with the greedy argmax on the device between them) and
``verify`` (the chunked wave, its argmax, the longest-prefix acceptance
and the rejected tail's index decrement, all on the device); the host
reads back only the greedy tokens [B, k+1] and the accepted counts [B].
The reference's two ``jax.jit`` programs are plain methods here.
``models.rollback_slot`` remains the semantic contract and the test
oracle of the fused index decrement.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculation knobs.  ``k`` drafted tokens per verify wave;
    ``draft_bits``/``draft_act_bits`` are the forced quantization of
    the self-speculation draft (the defaults pick the A4 tier: the
    activation bits, not the weight bits, buy packing density)."""
    k: int = 3
    draft_bits: int = 4
    draft_act_bits: int = 4

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.k}")


class SpecDecoder:
    """Draft derivation and the two speculative programs.

    Owned by the engine (one per process).  It holds the memoized draft
    parameter trees; the draft keeps no state across rounds (it forks
    the target's cache each round into the working cache the caller
    passes), so buckets sharing a batch width share the draft exactly
    like they share the target's packed parameters."""

    def __init__(self, cfg, params, config: Optional[SpecConfig] = None, *,
                 compute: str = "sdv", min_size: int = 1024,
                 conv_datapath: str = "bseg",
                 plan_policy: str = "auto",
                 plan_cache: Optional[str] = None):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(
                f"speculative decoding needs a KV-cache family with "
                f"chunked verify support, got {cfg.family!r}")
        self.cfg = cfg
        self.params = params
        self.config = config or SpecConfig()
        self.compute = compute
        self.min_size = min_size
        self.conv_datapath = conv_datapath
        self.plan_policy = plan_policy
        self.plan_cache = plan_cache
        self._draft_by_rows: Dict[int, Any] = {}

    def draft(self, qparams, cache, pending: torch.Tensor,
              adv: torch.Tensor, fork) -> torch.Tensor:
        """k greedy draft steps on a fork of the target's cache.

        ``fork`` is a cache of the same shapes (the bucket's draft
        working cache): it is overwritten from ``cache`` and the k
        ``decode_step``s write into it, never into ``cache``.  pending
        [B] int32 is each slot's next unconsumed token; ``adv`` [B]
        freezes the slots that do not speculate (their chain runs on
        garbage and is discarded).  The argmax between steps stays on
        the device.  Returns the proposals [B, k] int32."""
        from ..models import decode_step
        for name, leaf in fork.items():
            leaf.copy_(cache[name])
        c = dict(fork)
        tok = pending.to(torch.int32)[:, None]
        out = []
        for _ in range(self.config.k):
            logits, c = decode_step(self.cfg, qparams, c, tok, advance=adv)
            tok = torch.argmax(logits[:, -1, :self.cfg.vocab],
                               dim=-1).to(torch.int32)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1)

    def verify(self, qparams, cache, pending: torch.Tensor,
               props: torch.Tensor, adv: torch.Tensor,
               remaining: torch.Tensor):
        """One chunked target wave over all k + 1 positions, with the
        acceptance and the target cache's rollback on the device.

        Builds ``[pending | proposals]``, runs ``verify_step`` with
        ``n_valid = adv * (k + 1)``, takes the greedy argmax, accepts
        ``t = min(m + 1, remaining)`` tokens per slot (m matched
        proposals plus the target's own token at the first mismatch; 0
        where ``adv`` is 0) and rewinds each slot's index by the
        rejected tail, clamped at 0.  Returns (greedy [B, k+1] int32,
        t [B] int32, the rolled-back cache)."""
        from ..models import verify_step
        k = self.config.k
        tokens = torch.cat([pending.to(torch.int32)[:, None], props], dim=1)
        logits, c2 = verify_step(self.cfg, qparams, cache, tokens,
                                 adv * (k + 1))
        greedy = torch.argmax(logits[:, :, :self.cfg.vocab],
                              dim=-1).to(torch.int32)
        hits = (props == greedy[:, :k]).to(torch.int32)
        m = torch.cumprod(hits, dim=1).sum(dim=1)
        live = adv > 0
        t = torch.where(live, torch.minimum(m + 1, remaining),
                        0).to(torch.int32)
        rewind = torch.where(live, (k + 1) - t, 0)
        c2 = dict(c2, index=torch.clamp_min(c2["index"] - rewind,
                                            0).to(torch.int32))
        return greedy, t, c2

    def draft_qparams(self, rows: int) -> Any:
        """The self-speculation draft: the SAME checkpoint through
        ``serve_params`` at the forced draft bits, planner-resolved for
        ``rows`` decode rows (memoized per batch width, like the
        engine's target parameters)."""
        from ..models import serve_params
        if rows not in self._draft_by_rows:
            self._draft_by_rows[rows] = serve_params(
                self.params, bits=self.config.draft_bits,
                min_size=self.min_size, compute=self.compute,
                act_bits=self.config.draft_act_bits,
                conv_bseg=(self.compute == "sdv"
                           and self.conv_datapath == "bseg"),
                plan_policy=self.plan_policy, plan_cache=self.plan_cache,
                rows=rows)
        return self._draft_by_rows[rows]

    def plan_comparison(self, target_qp: Any, rows: int
                        ) -> List[Dict[str, Any]]:
        """Per GEMM layer: the target's resolved plan against the
        draft's, with packing densities — the acceptance gate is every
        draft layer strictly denser on the same datapath."""
        t = _sdv_plans(target_qp)
        d = _sdv_plans(self.draft_qparams(rows))
        out = []
        for path, (tn, tdesc, tdp) in sorted(t.items()):
            dn, ddesc, ddp = d.get(path, (0, "-", "-"))
            out.append({
                "layer": path,
                "datapath": tdp,
                "target_plan": tdesc, "target_density": tn,
                "draft_plan": ddesc, "draft_density": dn,
                "draft_denser": dn > tn and ddp == tdp,
            })
        return out


def _sdv_plans(tree: Any) -> Dict[str, Any]:
    from ..models.quantized import SDVLinear
    from ..planner import describe_plan
    out: Dict[str, Any] = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else k)
        elif isinstance(t, SDVLinear):
            out[path] = (int(t.plan.density), describe_plan(t.plan),
                         t.plan.spec.name)

    walk(tree, "")
    return out


def accept_length(proposals: np.ndarray, greedy: np.ndarray) -> int:
    """Longest accepted prefix: the number of draft proposals matching
    the target's greedy choices.  ``proposals`` [k] holds d_1..d_k,
    ``greedy`` [>= k] the target argmax at the verified positions (g_j
    is the target's choice after consuming d_1..d_j).  Proposal d_{j+1}
    is accepted iff it equals g_j, so the emitted tokens are always
    g_0..g_m: the target's own outputs, never the draft's."""
    m = 0
    k = len(proposals)
    while m < k and int(proposals[m]) == int(greedy[m]):
        m += 1
    return m


def calibration_tokens(rng: np.random.Generator, vocab: int, batch: int,
                       seq: int, mult: int, offset: int) -> np.ndarray:
    """One batch of the synthetic affine-cycle stream
    (``next = (mult * t + offset) % vocab`` from a random first column),
    drawn as the reference draws it."""
    col = rng.integers(0, vocab, (batch, 1))
    cols = [col]
    for _ in range(seq - 1):
        cols.append((cols[-1] * mult + offset) % vocab)
    return np.concatenate(cols, 1)


def calibration_loss(cfg, params, toks: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``toks`` [B, S] under
    ``models.forward`` (float32 log-softmax over the padded vocab)."""
    from ..models import forward
    logits = forward(cfg, params, {"tokens": toks})
    lp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    nll = -torch.gather(lp, -1, toks[:, 1:, None].long())
    return nll.mean()


def calibrated_params(cfg, *, steps: int = 350, seed: int = 0,
                      lr: float = 1e-2, batch: int = 8, seq: int = 32,
                      mult: int = 3, offset: int = 7, device="cuda",
                      losses: Optional[List[float]] = None) -> Any:
    """A briefly trained checkpoint for speculative benches and demos.

    Acceptance is a property of the *checkpoint*: a random-init model's
    logits are near-tied across the vocab, so a re-quantized draft
    flips the argmax and almost nothing is accepted.  A few hundred Adam
    steps on the synthetic affine-cycle stream (``calibration_tokens``,
    the reference's numpy stream) peak the next-token distribution
    enough that the W4A4 draft agrees with the W4A8 target.  The weights
    start from the port's seeded ``init_params``; gradients come from
    ``torch.autograd`` over ``models.forward``; the update is the
    reference's hand-written Adam, its moments in each parameter's
    dtype (bf16 for the bf16 weights) and its bias-corrected step in
    float32.  With ``losses`` (a list) each step's loss is appended, as
    a float (one host read a step)."""
    from ..device import resolve_device
    from ..models import init_params
    from ..models.layers import scalar_like

    dev = resolve_device(device)
    params = init_params(cfg, seed=seed, device=dev)
    names, leaves = _flatten(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    rng = np.random.default_rng(seed)
    for t in range(1, steps + 1):
        toks = torch.from_numpy(calibration_tokens(
            rng, cfg.vocab, batch, seq, mult, offset)).to(
            device=dev, dtype=torch.int32)
        loss = calibration_loss(cfg, _unflatten(names, leaves), toks)
        grads = torch.autograd.grad(loss, leaves)
        if losses is not None:
            losses.append(float(loss.detach()))
        tf = torch.tensor(t, dtype=torch.float32, device=dev)
        bc1, bc2 = 1 - b1 ** tf, 1 - b2 ** tf
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(leaves, grads)):
                # the reference's `b1 * m + (1 - b1) * g` in the moment's
                # dtype (JAX rounds the Python scalars to it)
                m[i] = scalar_like(b1, m[i]) * m[i] \
                    + scalar_like(1 - b1, g) * g
                v[i] = scalar_like(b2, v[i]) * v[i] \
                    + scalar_like(1 - b2, g) * g * g
                mh = m[i].to(torch.float32) / bc1
                vh = v[i].to(torch.float32) / bc2
                p.copy_((p.to(torch.float32) - lr * mh
                         / (torch.sqrt(vh) + eps)).to(p.dtype))
    for leaf in leaves:
        leaf.requires_grad_(False)
    return _unflatten(names, leaves)


def _flatten(tree, prefix=()):
    names, leaves = [], []
    for k, v in tree.items():
        if isinstance(v, dict):
            n, l = _flatten(v, prefix + (k,))
            names += n
            leaves += l
        else:
            names.append(prefix + (k,))
            leaves.append(v)
    return names, leaves


def _unflatten(names, leaves):
    out: Dict[str, Any] = {}
    for path, leaf in zip(names, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
