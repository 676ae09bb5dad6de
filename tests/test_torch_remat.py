"""Rematerialization in the torch port's full-sequence forward
(``models/transformer.py``: ``_maybe_remat``, ``_layer_loop``), on the
CPU.

  * For reduced models of every family — dense (tinyllama-1.1b), moe
    (phi3.5-moe, ``moe_every`` 1; llama4-maverick, ``moe_every`` 2), vlm
    (llava-next), encdec (seamless-m4t), ssm (mamba2-130m) and hybrid
    with trailing RG-LRU layers (recurrentgemma-2b) — deep enough for
    the JAX package's group condition at ``remat_group = 2``: the loss
    and every gradient of one microbatch with per-block remat, with
    sqrt-L groups (``scan_layers``), with groups alone (``remat=False``,
    as the JAX package groups), and with ``scan_layers=False`` (per-block
    only) are bit for bit those of no remat (``torch.equal``), and the
    checkpointed units are the JAX package's (a block, a layer group
    under ``moe_every > 1``, a Griffin group, a trailing layer, an
    encoder or decoder block; groups of ``remat_group`` of them but for
    the trailing layers), counted;
  * the STE's packed GEMM calls (B2 on the card) of one reduced QAT
    microbatch: the forward's F, plus every block's P once more (its
    recompute), plus (g - 1) of every g blocks once more under groups
    (a group's recompute stops once it has the input of its last
    block); a ``no_grad`` forward makes F whatever the settings;
  * ``MemTracker``'s peak of a reduced step on ``meta`` tensors at a
    sequence where activations dominate is lower with remat than
    without, and lower again with groups; the dry run's
    ``RankReckoner`` reckons the same peaks.

Against the JAX package: ``tests/test_torch_qat.py``'s two-step and
gradient tests run the port's default remat against the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import ops
from repro_torch.launch.dryrun import RankReckoner
from repro_torch.models import init_params, transformer
from repro_torch.train import loop, optimizer
from repro_torch.train.qat import ste

#: (arch, the depth replaced into its reduced config): remat_group 2
#: divides the units of every stack, and each stack has more than 2
DEPTHS = {
    "tinyllama-1.1b": dict(n_layers=4),
    "phi3.5-moe": dict(n_layers=4),
    "llama4-maverick": dict(n_layers=8),
    "llava-next-mistral-7b": dict(n_layers=4),
    "seamless-m4t-large-v2": dict(n_enc_layers=4, n_dec_layers=4),
    "mamba2-130m": dict(n_layers=4),
    "recurrentgemma-2b": dict(n_layers=14),
}
#: the settings against remat off (remat=False, remat_group=0)
SETTINGS = {
    "block": dict(remat=True, remat_group=0),
    "group": dict(remat=True, remat_group=2),
    "group_only": dict(remat=False, remat_group=2),
    "unrolled": dict(remat=True, remat_group=2, scan_layers=False),
}
OFF = dict(remat=False, remat_group=0)
SEQ, BATCH = 32, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, **over):
    return dataclasses.replace(get_arch(arch).reduced(), **DEPTHS[arch],
                               **over)


def _batch(cfg, seq=SEQ):
    rng = np.random.default_rng(0)

    def toks(n):
        return torch.from_numpy(
            rng.integers(0, cfg.vocab, (BATCH, n)).astype(np.int32))

    def floats(n):
        return torch.from_numpy(rng.standard_normal(
            (BATCH, n, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        return {"tokens": toks(seq - cfg.n_patches),
                "patches": floats(cfg.n_patches)}
    if cfg.family == "encdec":
        return {"src": floats(seq // 2), "tokens": toks(seq // 2)}
    return {"tokens": toks(seq)}


def _units(cfg):
    """(checkpointed blocks, checkpointed groups) of one forward at
    ``remat_group = 2`` from the JAX package's structure."""
    if cfg.family == "encdec":
        n = cfg.n_enc_layers + cfg.n_dec_layers
        return n, n // 2
    if cfg.family == "hybrid":
        groups = cfg.n_layers // 3
        return groups + cfg.n_layers % 3, groups // 2
    me = cfg.moe_every if cfg.family == "moe" else 1
    return cfg.n_layers // me, cfg.n_layers // me // 2


def _loss_and_grads(cfg, params, batch):
    """(loss, gradients, ``_remat`` calls of the forward)."""
    calls = [0]
    orig = transformer._remat

    def counted(fn, *args):
        calls[0] += 1
        return orig(fn, *args)
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformer, "_remat", counted)
        loss = loop.loss_fn(cfg, tree.unflatten(params, leaves), batch)
        n_fwd = calls[0]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), grads, n_fwd


@pytest.fixture(scope="module")
def off_runs():
    """arch -> (params, batch, remat off's loss, gradients and calls),
    made at first use."""
    runs = {}

    def get(arch):
        if arch not in runs:
            cfg = _cfg(arch, **OFF)
            params = init_params(cfg, seed=0, device="cpu")
            batch = _batch(cfg)
            runs[arch] = (params, batch,
                          _loss_and_grads(cfg, params, batch))
        return runs[arch]
    return get


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("arch", sorted(DEPTHS))
def test_remat_is_bit_exact_at_the_reference_boundaries(off_runs, arch,
                                                        setting):
    params, batch, (loss0, grads0, calls0) = off_runs(arch)
    cfg = _cfg(arch, **SETTINGS[setting])
    loss, grads, calls = _loss_and_grads(cfg, params, batch)
    assert calls0 == 0 and torch.isfinite(loss0)
    assert torch.equal(loss, loss0)
    assert len(grads) == len(grads0)
    for g, g0 in zip(grads, grads0):
        assert (g is None and g0 is None) or torch.equal(g, g0)
    blocks, groups = _units(cfg)
    want = {"block": blocks, "group": blocks + groups,
            "group_only": groups, "unrolled": blocks}[setting]
    assert calls == want, (calls, blocks, groups)


#: reduced tinyllama's QAT microbatch: 7 wrapped projections a layer and
#: the LM head
QAT_LAYERS, QAT_PER_LAYER = 6, 7


@pytest.fixture(scope="module")
def qat_model():
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").reduced(),
                              n_layers=QAT_LAYERS)
    params = ste.qat_params(init_params(cfg, seed=0, device="cpu"),
                            w_bits=4, a_bits=8, min_size=1 << 10,
                            plan_policy="auto")
    assert ste.count_qat_layers(params) == QAT_PER_LAYER + 1
    return cfg, params, _batch(cfg)


@pytest.mark.parametrize("remat,group", [(False, 0), (False, 2), (True, 0),
                                         (True, 2), (True, 3), (True, 6)])
def test_ste_calls_follow_the_recompute(qat_model, monkeypatch, remat,
                                        group):
    base, params, batch = qat_model
    cfg = dataclasses.replace(base, remat=remat, remat_group=group)
    calls = [0]
    orig = ops.packed_matmul

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)
    monkeypatch.setattr(ops, "packed_matmul", counted)
    blocks = QAT_LAYERS * QAT_PER_LAYER
    forward = blocks + 1                          # and the LM head
    grouped = 1 < group < QAT_LAYERS and QAT_LAYERS % group == 0
    want = forward
    if remat:
        want += blocks
    if grouped:
        # without per-block remat a group's recompute runs to its last
        # block's saved tensors, with it to its last block's input
        want += blocks if not remat else \
            QAT_LAYERS // group * (group - 1) * QAT_PER_LAYER
    _loss_and_grads(cfg, params, batch)
    assert calls[0] == want
    calls[0] = 0
    with torch.no_grad():
        loop.loss_fn(cfg, params, batch)
    assert calls[0] == forward


def _meta_step_peaks(cfg, seq):
    """MemTracker's and the dry run's ``RankReckoner``'s peak of one
    train step of ``cfg`` on ``meta`` tensors at batch 2 x ``seq``, its
    arguments included."""
    from torch.distributed._tools.mem_tracker import MemTracker
    params = init_params(cfg, device="meta")
    ocfg = optimizer.OptConfig()
    opt = optimizer.init(ocfg, params)
    batch = {"tokens": torch.empty((2, seq), dtype=torch.int32,
                                   device="meta")}
    args = tree.leaves((params, opt, batch))
    step = loop.make_train_step(cfg, ocfg, microbatches=1)
    # an untracked step first makes what the step caches for later calls
    # (``device.constant``'s scalars), which a first tracked step counts
    step(params, opt, batch)
    mt = MemTracker()
    mt.track_external(*args)
    with mt:
        step(params, opt, batch)
    rk = RankReckoner()
    for t in args:
        rk.hold(t)
    with rk:
        step(params, opt, batch)
    return (mt.get_tracker_snapshot("peak")[torch.device("meta")]["Total"],
            rk.peak)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m"])
def test_memtracker_peak_falls_with_remat(arch):
    base = dataclasses.replace(get_arch(arch).reduced(), n_layers=4,
                               attn_chunk=256)
    peaks = [_meta_step_peaks(dataclasses.replace(
        base, remat=r, remat_group=g), 512)
        for r, g in ((False, 0), (True, 0), (True, 2))]
    off, block, group = (mt for mt, _ in peaks)
    assert group < block < off, (off, block, group)
    # the dry run's tracker counts the same live storage
    assert all(mt == rk for mt, rk in peaks), peaks
