"""AdamW with cosine schedule, global-norm clipping, and optional 8-bit
moment states — torch port of ``repro.train.optimizer``.

The arithmetic is the JAX package's, step for step, in float32: the
moments, the bias corrections ``1 - b**step`` (float32 powers), the
global-norm clip over every leaf, the clip before the int8 cast of the
8-bit moments (block-wise dynamic quantization, block = last axis).  A
Python scalar meets a tensor only in products, sums and differences,
where torch rounds it to float32 first as JAX does; every division and
every power of a scalar goes through a float32 tensor
(``device.constant``), since torch divides by a Python number through
its reciprocal on the card and puts a scalar numerator through the
tensor's reciprocal everywhere.

Trees are walked in ``jax.tree_util`` order (``repro_torch.tree``): a
moment tree has its parameter tree's structure, a ``Q8`` moment in
place of a large float one when ``moments_8bit`` is set.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from .. import tree
from ..device import constant
from ..quant.quantizer import div


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    lr_min: float = 3e-5
    warmup: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_8bit: bool = False


class Q8(NamedTuple):
    """8-bit block-quantized tensor (block = last axis)."""
    q: torch.Tensor         # int8
    scale: torch.Tensor     # f32 [..., 1]


def is_q8(x) -> bool:
    return isinstance(x, Q8)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return constant(value, torch.float32, like.device)


def _q8(x: torch.Tensor) -> Q8:
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = div(torch.clamp_min(amax, 1e-12), 127.0)
    # clip before the int8 cast: float division can nudge amax/scale a
    # hair past 127, and the cast wraps rather than saturates
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return Q8(q.to(torch.int8), scale.to(torch.float32))


def _dq8(t: Q8) -> torch.Tensor:
    return t.q.to(torch.float32) * t.scale


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = div(cfg.lr * s, max(1, cfg.warmup))
    prog = torch.clamp(div(s - cfg.warmup,
                           max(1, cfg.total_steps - cfg.warmup)), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr - cfg.lr_min) \
        * (1.0 + torch.cos(math.pi * prog))
    return torch.where(s < cfg.warmup, warm, cos)


def init(cfg: OptConfig, params: Any) -> Any:
    def zeros_like_state(p):
        # zeros_like keeps a DTensor parameter's mesh and placements
        z = torch.zeros_like(p, dtype=torch.float32)
        if cfg.moments_8bit and p.ndim >= 1 and p.numel() >= 4096:
            return _q8(z)
        return z
    first = tree.leaves(params)
    dev = first[0].device if first else torch.device("cpu")
    return {
        "m": tree.tree_map(zeros_like_state, params),
        "v": tree.tree_map(zeros_like_state, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.leaves(grads)))


@torch.no_grad()
def update(cfg: OptConfig, grads: Any, state: Any, params: Any):
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    clip = torch.clamp_max(
        _f32(cfg.clip_norm, gnorm) / torch.clamp_min(gnorm, 1e-12), 1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, stepf), stepf)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, stepf), stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        m_f = _dq8(m) if is_q8(m) else m
        v_f = _dq8(v) if is_q8(v) else v
        m_f = cfg.b1 * m_f + (1.0 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1.0 - cfg.b2) * g * g
        u = (m_f / b1c) / (torch.sqrt(v_f / b2c) + cfg.eps)
        u = u + cfg.weight_decay * p.to(torch.float32)
        newp = (p.to(torch.float32) - lr * u).to(p.dtype)
        new_m = _q8(m_f) if is_q8(m) else m_f
        new_v = _q8(v_f) if is_q8(v) else v_f
        return newp, new_m, new_v

    flat_p = tree.leaves(params)
    flat_g = tree.leaves(grads)
    flat_m = tree.leaves(state["m"], is_q8)
    flat_v = tree.leaves(state["v"], is_q8)
    outs = [upd(p, g, m, v)
            for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_params = tree.unflatten(params, [o[0] for o in outs])
    new_m = tree.unflatten(state["m"], [o[1] for o in outs], is_q8)
    new_v = tree.unflatten(state["v"], [o[2] for o in outs], is_q8)
    new_state = {"m": new_m, "v": new_v, "step": step}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
