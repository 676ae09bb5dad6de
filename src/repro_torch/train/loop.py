"""Training step and step loop — torch port of ``repro.train.loop``:
next-token CE loss in sequence chunks, microbatched gradient
accumulation in float32, the AdamW update, and the registry-driven step
loop (``run_training``) with honest step timing — the device sync sits
INSIDE the timed region, so straggler detection and benchmark numbers
measure execution, not dispatch.

Gradients come from ``torch.autograd`` over ``models.forward``
(``train/qat/ste.py``'s autograd functions inside it under QAT); the JAX
package's ``lax.scan`` over loss chunks and microbatches is a Python
loop here, and its ``jax.jit`` of the step is not ported (the step runs
op by op).  Every family trains: dense, moe, vlm (the loss over the
text positions only), encdec, ssm and hybrid.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from .. import tree
from ..configs.base import ArchConfig
from ..device import constant
from ..models import forward, shard_ctx
from ..quant.quantizer import div
from . import optimizer, straggler


def loss_fn(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor],
            *, loss_chunk: int = 512):
    """Mean next-token cross entropy, computed in sequence chunks so the
    full [B, S, V] logits tensor is never materialized (the unembed +
    CE runs per chunk; memory is O(B * chunk * V))."""
    from ..models.transformer import unembed_hidden
    hidden = forward(cfg, params, batch, mode="hidden")
    if cfg.family == "vlm":
        hidden = hidden[:, cfg.n_patches:, :]     # text positions only
    hidden = hidden[:, :-1, :]
    targets = batch["tokens"][:, 1:].long()
    b, sm1, _ = hidden.shape
    c = min(loss_chunk, sm1)
    n_chunks = sm1 // c

    def ce_of(h_chunk, t_chunk):
        # [B,c,V] f32; on a mesh the vocab-sharded logits are gathered
        # first: the gather of the gold logit has no sharding rule there
        logits = shard_ctx.gather_to_batch(
            unembed_hidden(cfg, params, h_chunk))
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, t_chunk[..., None])[..., 0]
        return torch.sum(logz - gold)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        total = total + ce_of(hidden[:, sl], targets[:, sl])
    if n_chunks * c < sm1:
        total = total + ce_of(hidden[:, n_chunks * c:],
                              targets[:, n_chunks * c:])
    return div(total, b * sm1)


def make_train_step(cfg: ArchConfig, ocfg: optimizer.OptConfig,
                    *, microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)."""

    def grads_of(params, batch):
        """(loss, gradient of every leaf of ``params``, in leaf order)."""
        leaves = [p.detach().requires_grad_(True)
                  for p in tree.leaves(params)]
        loss = loss_fn(cfg, tree.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None
                               else shard_ctx.placed_as(g, p)
                               for p, g in zip(leaves, grads)]

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            mb = {k: shard_ctx.split_microbatches(v, microbatches)
                  for k, v in batch.items()}
            loss_sum = None
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in tree.leaves(params)]
            for i in range(microbatches):
                loss, g = grads_of(params, {k: v[i] for k, v in mb.items()})
                for acc, gi in zip(grads, g):
                    acc.add_(gi.to(torch.float32))
                del g
                loss_sum = loss if loss_sum is None else loss_sum + loss
            loss = div(loss_sum, microbatches)
            for acc in grads:
                acc.div_(constant(microbatches, torch.float32, acc.device))
        else:
            loss, grads = grads_of(params, batch)
        new_params, new_opt, metrics = optimizer.update(
            ocfg, tree.unflatten(params, grads), opt_state, params)
        metrics = dict(metrics, loss=loss)
        return new_params, new_opt, metrics

    return train_step


# ---------------------------------------------------------------------------
# the step loop
# ---------------------------------------------------------------------------

def device_of(params) -> torch.device:
    """The device of a tree's first tensor leaf (the CPU if it has
    none)."""
    for leaf in tree.leaves(params):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def run_training(cfg: ArchConfig, ocfg: optimizer.OptConfig, params, opt,
                 data, *, steps: int, start: int = 0,
                 microbatches: int = 1,
                 place_batch: Optional[Callable[[Dict], Dict]] = None,
                 monitor: Optional[straggler.StepMonitor] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sync: Optional[Callable[[Any], Any]] = None,
                 on_step: Optional[Callable[..., None]] = None,
                 step_fn=None):
    """Drive ``steps - start`` train steps over any registry arch.

    ``data.batch_at(step)`` supplies deterministic host batches,
    ``place_batch`` (optional) moves them to torch tensors (default: on
    the device of ``params``), ``on_step(step, params, opt, metrics, dt,
    monitor)`` hooks logging/checkpointing.  ``clock``/``sync`` are
    injectable for deterministic tests; the sync (default: wait for the
    card) runs INSIDE the monitor's timed region so recorded step times
    are honest under asynchronous launches.

    Returns ``(params, opt, metrics, monitor)``.
    """
    if step_fn is None:
        step_fn = make_train_step(cfg, ocfg, microbatches=microbatches)
    dev = device_of(params)
    if sync is None:
        def sync(_):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    mon = monitor if monitor is not None \
        else straggler.StepMonitor(clock=clock)
    metrics: Dict[str, Any] = {}
    for s in range(start, steps):
        host = data.batch_at(s)
        batch = place_batch(host) if place_batch is not None \
            else {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        mon.start()
        params, opt, metrics = step_fn(params, opt, batch)
        sync(metrics)                 # honest timing: sync inside
        dt = mon.stop()
        if on_step is not None:
            on_step(s, params, opt, metrics, dt, mon)
    return params, opt, metrics, mon


def init_run(arch: str, *, smoke: bool = False, steps: int = 100,
             global_batch: int = 8, seq: int = 128, seed: int = 0,
             lr: float = 3e-4, warmup: int = 10, device="cuda"):
    """Registry-driven setup: (cfg, ocfg, params, opt, data) for an
    assigned arch name — every shape comes from ``configs/registry``,
    nothing hardcoded.  One device, unsharded; the parameters are the
    port's seeded ``init_params`` on ``device``."""
    from ..configs.registry import get_arch
    from ..data import SyntheticLMData
    from ..models import init_params

    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    params = init_params(cfg, seed=seed, device=device)
    ocfg = optimizer.OptConfig(lr=lr, warmup=warmup, total_steps=steps,
                               moments_8bit=cfg.opt_8bit)
    opt = optimizer.init(ocfg, params)
    data = SyntheticLMData(
        vocab=cfg.vocab, seq_len=seq, global_batch=global_batch,
        seed=seed, n_patches=cfg.n_patches, d_model=cfg.d_model,
        encdec=cfg.family == "encdec")
    return cfg, ocfg, params, opt, data
