"""QAT training run: float init -> STE packed forward -> export —
torch port of ``repro.train.qat.loop``.

The trainable state IS the wrapped tree: ``qat_params`` replaces each
packable kernel with a ``QATLinear`` whose only tree leaf is the float
master kernel, so the standard ``train/loop`` step, AdamW optimizer and
checksummed checkpoints all operate on it unchanged (gradients flow to
the float kernels through the STE autograd functions).  Export unwraps
back to floats and hands them to ``serve_params`` — the contract being
that the integers serving decodes are the integers QAT trained against
(same rule, same statistics).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import checkpoint, loop, optimizer, straggler
from . import ste


@dataclasses.dataclass(frozen=True)
class QATRunConfig:
    arch: str = "tinyllama-1.1b"
    smoke: bool = True              # reduced same-family config
    steps: int = 20
    global_batch: int = 8
    seq: int = 64
    microbatches: int = 1
    lr: float = 1e-3
    warmup: int = 2
    seed: int = 0
    # quantization
    w_bits: int = 4
    a_bits: int = 8
    min_size: int = 1 << 10
    # forward mode: packed routes the STE GEMMs through the planner +
    # packed_matmul dispatch; unpacked runs the bit-identical integer
    # decode (same arithmetic)
    packed_forward: bool = True
    plan_policy: str = "auto"       # for packed_forward plan resolution
    plan_cache: Optional[str] = None
    rows: Optional[int] = None
    # checkpointing
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    resume: bool = False
    # eval
    eval_batches: int = 4
    eval_offset: int = 10_000       # batch_at offset — held-out stream
    # the torch device the run lives on
    device: str = "cuda"


@torch.no_grad()
def evaluate(cfg, params, data, *, batches: int, offset: int) -> float:
    """Mean CE loss over ``batches`` held-out deterministic batches, op
    by op.  Works on float, QAT-wrapped, or served parameter trees — the
    forward dispatches on the container type."""
    dev = loop.device_of(params)
    total = 0.0
    for i in range(batches):
        total += float(loop.loss_fn(cfg, params,
                                    data.device_batch(offset + i, dev)))
    return total / max(batches, 1)


def export_for_serving(qcfg: QATRunConfig, params: Any,
                       plan_policy: Optional[str] = None) -> Any:
    """Unwrap the QAT tree and rewrite it for packed serving — the
    QAT -> export -> serve contract.  ``params`` may be wrapped or
    already float."""
    from ...models import serve_params
    from ...models.quantized import PLANNER_DECODE_ROWS
    return serve_params(
        ste.float_params(params), bits=qcfg.w_bits,
        min_size=qcfg.min_size, compute="sdv", act_bits=qcfg.a_bits,
        plan_policy=plan_policy or qcfg.plan_policy,
        plan_cache=qcfg.plan_cache,
        rows=qcfg.rows or PLANNER_DECODE_ROWS)


def run_qat(qcfg: QATRunConfig, *,
            precision: Optional[Dict[str, Tuple[int, int]]] = None,
            clock: Callable[[], float] = time.monotonic,
            sync: Optional[Callable[[Any], Any]] = None,
            log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Run QAT from float init over a registry arch, on
    ``qcfg.device``.

    Returns a result dict: the wrapped ``params`` (float masters
    inside), ``float_eval``/``qat_eval`` losses (the float baseline is
    evaluated on the SAME init for an apples-to-apples gap), per-step
    wall times, and counters.  ``precision`` (from ``bitsearch``)
    overrides per-layer bitwidths.
    """
    cfg, ocfg, float_init, float_opt, data = loop.init_run(
        qcfg.arch, smoke=qcfg.smoke, steps=qcfg.steps,
        global_batch=qcfg.global_batch, seq=qcfg.seq, seed=qcfg.seed,
        lr=qcfg.lr, warmup=qcfg.warmup, device=qcfg.device)
    del float_opt                   # the QAT tree gets its own state

    params = ste.qat_params(
        float_init, w_bits=qcfg.w_bits, a_bits=qcfg.a_bits,
        min_size=qcfg.min_size, precision=precision,
        plan_policy=qcfg.plan_policy if qcfg.packed_forward
        else "default",
        plan_cache=qcfg.plan_cache, rows=qcfg.rows)
    n_qat = ste.count_qat_layers(params)
    if n_qat == 0:
        raise ValueError(
            f"no packable layer >= min_size={qcfg.min_size} in "
            f"{qcfg.arch!r} — QAT would train a plain float model")
    opt = optimizer.init(ocfg, params)

    start = 0
    ck = None
    if qcfg.ckpt_dir:
        ck = checkpoint.AsyncCheckpointer(qcfg.ckpt_dir)
        if qcfg.resume:
            last = checkpoint.latest_step(qcfg.ckpt_dir)
            if last is not None:
                (params, opt), meta = checkpoint.restore(
                    qcfg.ckpt_dir, last, (params, opt))
                start = meta["step"]
                log(f"[qat] resumed at step {start}")

    losses = []

    def on_step(s, p, o, metrics, dt, mon):
        losses.append(float(metrics["loss"]))
        if ck is not None and qcfg.ckpt_every \
                and (s + 1) % qcfg.ckpt_every == 0:
            ck.save_async(s + 1, (p, o))
        if (s + 1) % 10 == 0 or s == start:
            log(f"[qat] step {s + 1:4d} loss {losses[-1]:.4f} "
                f"({dt * 1e3:.1f} ms)")

    mon = straggler.StepMonitor(clock=clock)
    params, opt, metrics, mon = loop.run_training(
        cfg, ocfg, params, opt, data, steps=qcfg.steps, start=start,
        microbatches=qcfg.microbatches, monitor=mon, clock=clock,
        sync=sync, on_step=on_step)
    if ck is not None:
        ck.save_async(qcfg.steps, (params, opt))
        ck.wait()

    qat_eval = evaluate(cfg, params, data, batches=qcfg.eval_batches,
                        offset=qcfg.eval_offset)
    float_eval = evaluate(cfg, float_init, data,
                          batches=qcfg.eval_batches,
                          offset=qcfg.eval_offset)
    return {
        "cfg": cfg, "ocfg": ocfg, "params": params, "opt": opt,
        "data": data, "losses": losses, "step_times": list(mon.history),
        "qat_layers": n_qat, "qat_eval": qat_eval,
        "float_eval_at_init": float_eval, "start": start,
    }
