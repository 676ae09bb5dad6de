"""The fixed-shape cache writes and the sharded decode step of the torch
port, against the JAX package.

(a) The writes.  ``layers.decode_attention`` / ``prefill_attention`` /
    ``decode_attention_ring`` and ``moe_apply``'s dispatch against the
    reference's, run op by op, on the same seeded inputs.  The projections and
    activations hold -1, 0 and 1 (their bf16 products and sums are
    exact in both packages), so every cache leaf must come out bit for
    bit.  The cache starts filled with random entries, so an entry that
    must not be written shows it.  Edges: rows at ``s_max - 1`` and at
    ``s_max`` (the latter writes nothing: position ``s_max - 1`` keeps
    its entry), ``write_mask`` False, ``n_valid`` 0, and a prefill chunk
    that crosses ``s_max``.  Each on the int8 cache with scales, the
    int8 cache without (``moe_every > 1`` layers, reference property
    (e)) and the bf16 cache.  The attention outputs agree within one
    bf16 rounding of their scale.
(b) No host sync.  A ``TorchDispatchMode`` records every aten op of
    ``decode_step`` (and ``prefill_step`` and ``verify_step`` where the
    family has them) of each family in memory mode (and of tinyllama in
    SDV mode): none is
    ``nonzero``, ``_local_scalar_dense`` or ``masked_select``, and no
    ``index``/``index_put`` takes a bool index.
(c) The sharded decode.  Four ``gloo`` ranks (``tests/torch_mesh_ranks.py``
    job ``mesh_decode``) place each reduced model's memory-packed tree
    and cache on a (2, 2) ("data", "model") mesh (``place_decode``) and
    decode ``STEPS`` steps from per-row positions that run past
    ``s_max``.  Their logits must be within ``MESH_TOL`` of the
    reference's single-device decode (jitted) on the same words and
    scales.  The same job materializes ``PackedLinear``s of ``DTensor``s
    through the per-shard route the card takes (aligned shards, a
    shorter last shard, shards that must be gathered first): bit for
    bit the single-device ``materialize``, in the words' placements.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.registry import get_arch as j_get_arch
from repro.models import Rules as JRules
from repro.models import decode_step as j_decode_step
from repro.models import init_cache as j_init_cache
from repro.models import layers as jlayers
from repro.models import transformer as jtrans
from repro.models import values as j_values

import repro_torch.models as tm
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import packbits
from repro_torch.launch import dryrun as DR
from repro_torch.models import layers as tlayers
from repro_torch.models import quantized as tquant
from repro_torch.models import transformer as ttrans
from test_torch_kv_bf16 import _to_reference
from test_torch_moe import _close

ROOT = Path(__file__).resolve().parents[1]
B, S_MAX, D, H, G, HD = 4, 8, 128, 4, 2, 32
I32 = dict(dtype=torch.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the writes
# ---------------------------------------------------------------------------

def _ternary(rng, shape):
    return rng.integers(-1, 2, shape).astype(np.float32)


def _attn_params(rng):
    shapes = {"wq": (D, H * HD), "wk": (D, G * HD), "wv": (D, G * HD),
              "wo": (H * HD, D)}
    return {k: {"kernel": _ternary(rng, s)} for k, s in shapes.items()}


def _to_t(tree):
    return tm.params_from_numpy(tree, device="cpu")


def _to_j(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32
        else jnp.asarray(a), tree)


def _cache(rng, kind, s_max=S_MAX):
    """(k, v, k_scale, v_scale) numpy, filled with random entries."""
    shape = (B, s_max, G, HD)
    if kind == "bf16":
        kv = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(2)]
        return kv + [None, None]
    kv = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
    if kind == "int8_unscaled":
        return kv + [None, None]
    return kv + [rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32)
                 for _ in range(2)]


def _as_t(a):
    if a is None:
        return None
    if a.dtype == np.float32 and a.ndim == 4:          # the bf16 K/V
        return torch.from_numpy(a).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _as_j(a):
    if a is None:
        return None
    if a.dtype == np.float32 and a.ndim == 4:
        return jnp.asarray(a, jnp.bfloat16)
    return jnp.asarray(a)


def _bits(x):
    x = np.asarray(x) if not isinstance(x, torch.Tensor) else x
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


#: name -> (step, cache_index, write_mask or n_valid, chunk)
WRITES = {
    "decode_at_last": ("decode", [S_MAX - 1, S_MAX - 1, 2, 0], None, 1),
    "decode_at_s_max": ("decode", [S_MAX, S_MAX, S_MAX - 1, 1], None, 1),
    "decode_write_mask": ("decode", [0, 3, S_MAX - 1, S_MAX],
                          [False, True, False, True], 1),
    "prefill_n_valid_0": ("prefill", [0, 2, S_MAX - 3, S_MAX], [0, 3, 0, 2],
                          3),
    "prefill_crosses_s_max": ("prefill", [S_MAX - 2, S_MAX - 1, S_MAX, 1],
                              [3, 3, 3, 2], 3),
}


@pytest.mark.parametrize("kind", ["int8", "int8_unscaled", "bf16"])
@pytest.mark.parametrize("case", sorted(WRITES))
def test_writes_match_reference(kind, case):
    step, index, extra, c = WRITES[case]
    rng = np.random.default_rng(sorted(WRITES).index(case))
    params = _attn_params(rng)
    x = _ternary(rng, (B, c, D))
    cache = _cache(rng, kind)
    index = np.asarray(index, np.int32)
    acfg = tlayers.AttnConfig(n_heads=H, n_kv=G, head_dim=HD)
    jcfg = jlayers.AttnConfig(d_model=D, n_heads=H, n_kv=G, head_dim=HD)
    tc = tuple(_as_t(a) for a in cache)
    jc = dict(cache_k=_as_j(cache[0]), cache_v=_as_j(cache[1]),
              cache_k_scale=_as_j(cache[2]), cache_v_scale=_as_j(cache[3]))
    tp, xt = _to_t(params), _to_t({"x": x})["x"].to(torch.bfloat16)
    ti = torch.from_numpy(index)
    if step == "decode":
        mask = None if extra is None else np.asarray(extra)
        writes = tlayers.decode_writes(
            ti, None if mask is None else torch.from_numpy(mask), S_MAX)
        ty = tlayers.decode_attention(tp, acfg, xt, cache=tc, cache_index=ti,
                                      writes=writes)
        jout = jlayers.decode_attention(
            _to_j(params), jcfg, jnp.asarray(x, jnp.bfloat16),
            cache_index=jnp.asarray(index), write_mask=None if mask is None
            else jnp.asarray(mask), **jc)
        jy, jcache = jout[0], jout[1:]
        wrote = (index < S_MAX) & (True if mask is None else mask)
        n_wrote = wrote.astype(int)
    else:
        n_valid = np.asarray(extra, np.int32)
        writes = tlayers.prefill_writes(ti, torch.from_numpy(n_valid), c,
                                        S_MAX)
        ty = tlayers.prefill_attention(tp, acfg, xt, cache=tc,
                                       cache_index=ti, writes=writes)
        jout = jlayers.prefill_attention(
            _to_j(params), jcfg, jnp.asarray(x, jnp.bfloat16),
            cache_index=jnp.asarray(index), n_valid=jnp.asarray(n_valid),
            **jc)
        jy, jcache = jout[0], jout[1:]
        n_wrote = np.clip(np.minimum(n_valid, S_MAX - index), 0, None)
    # every leaf bit for bit, the untouched entries included
    names = ("k", "v", "k_scale", "v_scale")
    for name, t, j in zip(names, tc, jcache):
        assert t is not None
        assert (_bits(t) == _bits(j)).all(), f"{case} {kind} {name}"
    for name, t, a in zip(names, tc, cache):
        if t is None:
            continue
        before = _bits(_as_t(a))
        changed = (_bits(t) != before).reshape(B, S_MAX, -1).any(-1)
        for r in range(B):
            lo = int(index[r])
            allowed = np.zeros(S_MAX, bool)
            allowed[lo:lo + int(n_wrote[r])] = True
            assert not (changed[r] & ~allowed).any(), (case, name, r)
            if lo >= S_MAX:
                # a row at s_max drops its write: s_max - 1 keeps its entry
                assert not changed[r, S_MAX - 1], (case, name, r)
    _close(ty.float().numpy(), np.asarray(jy, np.float32), f"{case} {kind} y")


def test_ring_write_matches_reference():
    """``decode_attention_ring`` vs the reference's ``_decode_attn_ring``
    at positions that wrap the ring (one slot past a full turn, one
    before its first): the ring bit for bit, the output within one bf16
    rounding."""
    rng = np.random.default_rng(7)
    window = 4
    params = _attn_params(rng)
    x = _ternary(rng, (B, 1, D))
    ring = [rng.standard_normal((B, window, G, HD)).astype(np.float32)
            for _ in range(2)]
    index = np.asarray([0, 3, 4, 9], np.int32)
    cfg = dataclasses.replace(j_get_arch("recurrentgemma-2b").reduced(),
                              n_heads=H, n_kv=G, head_dim=HD, d_model=D)
    jy, jk, jv = jtrans._decode_attn_ring(
        _to_j(params), cfg, jnp.asarray(x, jnp.bfloat16), _as_j(ring[0]),
        _as_j(ring[1]), jnp.asarray(index), window=window)
    acfg = tlayers.AttnConfig(n_heads=H, n_kv=G, head_dim=HD,
                              rope_theta=cfg.rope_theta)
    tk, tv = _as_t(ring[0]), _as_t(ring[1])
    ty = tlayers.decode_attention_ring(
        _to_t(params), acfg, _to_t({"x": x})["x"].to(torch.bfloat16),
        k_cache=tk, v_cache=tv, cache_index=torch.from_numpy(index),
        window=window)
    assert (_bits(tk) == _bits(jk)).all() and (_bits(tv) == _bits(jv)).all()
    _close(ty.float().numpy(), np.asarray(jy, np.float32), "ring y")


@pytest.mark.parametrize("skew", [True, False])
def test_moe_dispatch_matches_reference(skew):
    """``moe_apply`` vs the reference's on 24 tokens (4 experts, top-2:
    capacity 15), with a router that sends every token to expert 0 first
    (9 choices dropped) and with a random one (2 dropped): the
    dispatch is the reference's fixed-shape scatter-add (a dropped
    choice adds 0 into its expert's last slot)."""
    rng = np.random.default_rng(int(skew))
    e, f, t = 4, 64, 24
    router = rng.standard_normal((D, e)).astype(np.float32) * 0.1
    x = rng.standard_normal((1, t, D)).astype(np.float32)
    if skew:
        x, router[:, 0] = np.abs(x), 1.0
    params = {"router": {"kernel": router},
              "wi_gate": _ternary(rng, (e, D, f)),
              "wi_up": _ternary(rng, (e, D, f)),
              "wo": _ternary(rng, (e, f, D))}
    cfg = dict(d_model=D, d_ff=f, n_experts=e, top_k=2)
    jp = _to_j(params)
    jp["router"]["kernel"] = jnp.asarray(params["router"]["kernel"])
    jy = jlayers.moe_apply(jp, jlayers.MoEConfig(**cfg),
                           jnp.asarray(x, jnp.bfloat16))
    tp = _to_t(params)
    for k in ("wi_gate", "wi_up", "wo"):
        tp[k] = tp[k].to(torch.bfloat16)
    tcfg, xt = tlayers.MoEConfig(**cfg), torch.from_numpy(x).to(
        torch.bfloat16)
    keep = tlayers.moe_route(tp, tcfg, xt.reshape(t, D))[3]
    assert int((~keep).sum()) == (9 if skew else 2)
    ty = tlayers.moe_apply(tp, tcfg, xt)
    _close(ty.float().numpy(), np.asarray(jy, np.float32), f"moe {skew}")


# ---------------------------------------------------------------------------
# (b) no host sync
# ---------------------------------------------------------------------------

SYNC_OPS = {"nonzero", "_local_scalar_dense", "masked_select"}
FAMILIES = ["tinyllama-1.1b", "phi3.5-moe", "llama4-maverick",
            "seamless-m4t-large-v2", "llava-next-mistral-7b", "mamba2-130m",
            "recurrentgemma-2b"]


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = set()
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._overloadpacket.__name__
        self.seen.add(name)
        if name in SYNC_OPS:
            self.bad.append(name)
        if name.startswith("index"):
            for a in list(args) + list(kwargs.values()):
                idx = a if isinstance(a, (list, tuple)) else ()
                if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                       for i in idx):
                    self.bad.append(f"{name} by a bool tensor")
        return func(*args, **kwargs)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serving_steps_never_sync_the_host(arch):
    cfg = get_arch(arch).reduced()
    params = tm.init_params(cfg, seed=0, device="cpu")
    tok = torch.ones((2, 1), **I32)
    # the writes are the same in both modes; SDV on the main path's model
    for compute in ("memory",) + (("sdv",) if arch == FAMILIES[0] else ()):
        q = tm.serve_params(params, bits=4, min_size=1024, compute=compute)
        cache = tm.init_cache(cfg, 2, 3, device="cpu")
        with _OpLog() as log, torch.no_grad():
            for _ in range(4):               # past s_max: the writes drop
                _, cache = tm.decode_step(cfg, q, cache, tok)
            if cfg.family in ttrans._KV_FAMILIES:
                _, cache = tm.decode_step(cfg, q, cache, tok,
                                          advance=torch.tensor([1, 0]))
                cache = tm.prefill_step(cfg, q, cache,
                                        torch.ones((2, 4), **I32),
                                        torch.tensor([4, 0], **I32))
                _, cache = tm.verify_step(cfg, q, cache,
                                          torch.ones((2, 3), **I32),
                                          torch.tensor([3, 1], **I32))
        assert log.bad == [], (arch, compute, sorted(set(log.bad)))
        if cfg.family != "ssm":
            assert "scatter_" in log.seen, (arch, sorted(log.seen))


# ---------------------------------------------------------------------------
# (c) the sharded decode on a (2, 2) gloo mesh
# ---------------------------------------------------------------------------

STEPS = 4
MESH_B, MESH_S = 4, 6
#: per-row start positions: the last row runs past s_max (its writes drop)
START = [0, 1, 3, 4]
#: (arch, serve_kv_bits) of each case
CASES = {"tinyllama-int8": ("tinyllama-1.1b", 8),
         "tinyllama-bf16": ("tinyllama-1.1b", 16),
         "phi3.5-moe": ("phi3.5-moe", 8),
         "mamba2-130m": ("mamba2-130m", 8),
         "recurrentgemma-2b": ("recurrentgemma-2b", 8),
         "seamless": ("seamless-m4t-large-v2", 8)}
MIN_SIZE = 1024
#: mesh logits vs the reference's single-device logits, as a share of
#: their largest magnitude: on the mesh a row-parallel projection sums
#: per-rank bf16 partial products (DTensor's all-reduce of a Partial in
#: bf16), one extra bf16 rounding a sum, carried through the layers and
#: into the int8 cache's quantization (the port's single-device logits
#: are within one bf16 rounding, 2^-7, of the reference's).  A MoE
#: router near a tie can pick other experts on either side: phi3.5-moe's
#: step 1 here is one (the port's single-device decode and the jitted
#: reference differ there by 0.35; the mesh routes as the reference)
MESH_TOL = 2.0 ** -5


def _packed_cases(rng):
    """(PackedLinear, placements: the tensor dimension each mesh dimension
    shards, None = replicated) for the per-shard materialize check."""
    def pl(lead, d_in, d_out, bits=4):
        kernel = torch.from_numpy(rng.standard_normal(
            lead + (d_in, d_out)).astype(np.float32))
        return tquant.pack_linear(kernel, bits=bits)
    return [(pl((), 16, 64), (None, 1)),          # aligned shards
            (pl((), 16, 31), (None, 1)),          # the last shard shorter
            (pl((), 16, 37), (None, 1)),          # words split unevenly
            (pl((), 16, 64), (0, 1)),             # d_in and d_out sharded
            (pl((4,), 8, 32, bits=2), (0, 2)),    # a stack, both
            (pl((2,), 8, 24), (None, 2))]         # a stack, gathered


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_decode")
    rng = np.random.default_rng(0)
    cases, refs = {}, {}
    for name, (arch, kv_bits) in CASES.items():
        tcfg = dataclasses.replace(get_arch(arch).reduced(),
                                   serve_kv_bits=kv_bits)
        q = tm.serve_params(tm.init_params(tcfg, seed=0, device="cpu"),
                            bits=4, min_size=MIN_SIZE)
        cache = tm.init_cache(tcfg, MESH_B, MESH_S, device="cpu")
        cache["index"] = torch.tensor(START, **I32)
        tokens = rng.integers(0, tcfg.vocab, (STEPS, MESH_B, 1))
        cases[name] = dict(cfg=tcfg, params=q, cache=cache,
                           tokens=torch.from_numpy(tokens.astype(np.int32)))
        refs[name] = (arch, kv_bits, q, tokens)
    packed = _packed_cases(rng)
    torch.save({"cases": cases, "min_size": MIN_SIZE, "packed": packed},
               tmp / "in.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ranks = subprocess.Popen([sys.executable,
                              str(ROOT / "tests" / "torch_mesh_ranks.py"),
                              "mesh_decode", "4", str(tmp / "in.pt"),
                              str(tmp)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    # meanwhile: the reference's single-device decode of the same trees
    ref_logits = {}
    for name, (arch, kv_bits, q, tokens) in refs.items():
        jcfg = dataclasses.replace(j_get_arch(arch).reduced(),
                                   serve_kv_bits=kv_bits)
        cache = j_values(j_init_cache(jcfg, JRules(), MESH_B, MESH_S))
        cache["index"] = jnp.asarray(START, jnp.int32)
        step = jax.jit(functools.partial(j_decode_step, jcfg))
        jq, out = _to_reference(q), []
        for t in tokens:
            lg, cache = step(jq, cache, jnp.asarray(t, jnp.int32))
            out.append(np.asarray(lg))
        ref_logits[name] = np.stack(out)
    stdout, stderr = ranks.communicate(timeout=600)
    assert ranks.returncode == 0, stdout + stderr
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(4)]
    expect = [tquant.materialize(p, torch.bfloat16) for p, _ in packed]
    return got, ref_logits, expect


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_decode_matches_reference(mesh_run, name):
    got, ref_logits, _ = mesh_run
    ref = ref_logits[name]
    for r, out in enumerate(got):
        lg = out[name].numpy()
        assert lg.shape == ref.shape and np.isfinite(lg).all()
        np.testing.assert_allclose(
            lg, ref, rtol=0, atol=MESH_TOL * np.abs(ref).max(),
            err_msg=f"{name} rank {r}")
        assert out[name + "/index"].tolist() == [s + STEPS for s in START]
    # every rank gathered the same logits
    assert all(torch.equal(o[name], got[0][name]) for o in got)


def test_mesh_materialize_runs_per_shard(mesh_run):
    got, _, expect = mesh_run
    for out in got:
        for (placed, full), want in zip(out["materialize"], expect):
            assert placed
            assert full.dtype == want.dtype and torch.equal(
                full.view(torch.int16), want.view(torch.int16))


def test_cuda_dtensor_never_reaches_the_launch(monkeypatch):
    """A ``DTensor`` headed for the CUDA launch of B7 raises (it has no
    data pointer of its own); ``materialize`` of a ``DTensor`` tree takes
    the per-shard route (here on a one-rank mesh, each shard's call on
    the plain version, as on the CPU): bit for bit the plain
    ``materialize``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    pl = tquant.pack_linear(torch.randn(16, 40), bits=4)
    want = tquant.materialize(pl, torch.bfloat16)
    with DR.fake_world(1):
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        words = distribute_tensor(pl.words, mesh, [Shard(1)])
        scale = distribute_tensor(pl.scale, mesh, [Replicate()])
        monkeypatch.setattr(packbits, "plain_route", lambda t: False)
        with pytest.raises(TypeError, match="DTensor"):
            packbits.unpack_dequant(words, scale.reshape(1, -1), w=4,
                                    d_out=40, rows_per_scale=16)
        monkeypatch.undo()
        got = tquant.materialize(
            dataclasses.replace(pl, words=words, scale=scale),
            torch.bfloat16)
        assert tuple(got.placements) == (Shard(1),)
        assert torch.equal(got.full_tensor(), want)
