"""Parity of the torch port's planner (``repro_torch.planner``) with the
JAX package's (``repro.planner``).

The analytic planner is pure Python over each package's own datapath
dimensioning and route tables, so the two must agree exactly: the same
enumerated candidates in the same order, the same cost breakdown (route,
reason, wide multiplies, overhead, score) for every candidate, and the
same choice with the same runner-ups, for every layer of reduced
tinyllama-1.1b, mamba2-130m and recurrentgemma-2b and of UltraNet at
416x416.  The full-width shape walk runs on the meta device (no weight
drawn or allocated).  Plan caches cross between the packages (the JSON
layout is the reference's, keyed by backend: ``"cpu"`` in both here),
and ``serve_params(plan_policy="auto", rows=8)`` packs the same words as
the reference's, bit for bit, from the same weights
(``models/convert.py``).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import planner as jp
from repro.configs.registry import get_arch
from repro.models import Rules, init_params, values
from repro.models import quantized as jq

from repro_torch import planner as tp
from repro_torch.models import params_from_numpy
from repro_torch.models import quantized as tq

ARCHS = ("tinyllama-1.1b", "mamba2-130m", "recurrentgemma-2b")
ULTRA_SIZE = 416


def _pd(plan):
    return jp.plan_to_dict(plan)


def _cost(c):
    return (c.route, c.reason, c.wide_multiplies, c.overhead, c.score,
            c.macs)


def _choice(ch, to_dict):
    return (to_dict(ch.plan), _cost(ch.cost),
            [(to_dict(p), _cost(c)) for p, c in ch.alternatives],
            ch.measured_us)


def _assert_layer_parity(js, ts):
    """Every candidate of one layer: same plans, costs, routes, choice."""
    assert js.key() == ts.key() and js.name == ts.name
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    jc, tc = jp.enumerate_plans(js), tp.enumerate_plans(ts)
    assert [_pd(p) for p in jc] == [tp.plan_to_dict(p) for p in tc]
    for jplan, tplan in zip(jc, tc):
        assert jp.route_for(js, jplan) == tp.route_for(ts, tplan)
        assert _cost(jp.score_plan(js, jplan)) \
            == _cost(tp.score_plan(ts, tplan))
    assert _choice(jp.choose_plan(js), _pd) \
        == _choice(tp.choose_plan(ts), tp.plan_to_dict)
    jd, td = jp.default_plan_for(js), tp.default_plan_for(ts)
    assert (jd is None and td is None) or _pd(jd) == tp.plan_to_dict(td)


def _arch_specs(arch, smoke):
    return (jp.arch_layer_specs(arch, smoke=smoke, min_size=1024),
            tp.arch_layer_specs(arch, smoke=smoke, min_size=1024))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_arch_layers_match_reference(arch):
    js, ts = _arch_specs(arch, smoke=True)
    assert [s.key() for s in js] == [s.key() for s in ts] and js
    for a, b in zip(js, ts):
        _assert_layer_parity(a, b)


@pytest.mark.parametrize("layer", range(9))
def test_ultranet_layers_match_reference(layer):
    js = jp.ultranet_layer_specs(ULTRA_SIZE)
    ts = tp.ultranet_layer_specs(ULTRA_SIZE)
    assert len(js) == len(ts) == 9
    _assert_layer_parity(js[layer], ts[layer])


def test_plan_ultranet_matches_reference():
    jc = jp.plan_ultranet(ULTRA_SIZE)
    tc = tp.plan_ultranet(ULTRA_SIZE)
    assert [_choice(c, _pd) for c in jc] \
        == [_choice(c, tp.plan_to_dict) for c in tc]
    assert jp.format_plan_table(jc, title="t") \
        == tp.format_plan_table(tc, title="t")


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_arch_full_width_matches_reference(arch):
    """Full-width plans through the shape path: the same layer specs,
    the same ``describe_plan`` strings and plan table."""
    js, ts = _arch_specs(arch, smoke=False)
    assert [s.key() for s in js] == [s.key() for s in ts] and js
    jc, tc = jp.plan_layers(js), tp.plan_layers(ts)
    assert [jp.describe_plan(c.plan) for c in jc] \
        == [tp.describe_plan(c.plan) for c in tc]
    assert jp.format_plan_table(jc) == tp.format_plan_table(tc)


def test_full_width_shape_walk_allocates_nothing():
    """``init_params(device="meta")`` gives the full-width tree's
    shapes and dtypes with no storage: tinyllama-1.1b's 1.1B
    parameters are never drawn."""
    from repro_torch.configs.registry import get_arch as t_get_arch
    from repro_torch.models import init_params as t_init

    tree = t_init(t_get_arch("tinyllama-1.1b"), device="meta")
    leaves = []

    def walk(node):
        for v in node.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(tree)
    assert all(v.is_meta for v in leaves)
    assert sum(v.numel() for v in leaves) > 1_000_000_000
    assert tuple(tree["blocks"]["mlp"]["wi_gate"]["kernel"].shape) \
        == (22, 2048, 5632)


def test_plan_cache_roundtrip_and_corrupt(tmp_path):
    layer = tp.matmul_spec("p", 8, 256, 96, w_bits=4, a_bits=8)
    path = str(tmp_path / "plans.json")
    cache = tp.PlanCache.load(path)
    assert cache.entries == {}
    choice = tp.choose_plan(layer)
    cache.put_choice(choice, source="analytic")
    cache.save()
    back = tp.PlanCache.load(path).get_choice(layer)
    assert back.plan == choice.plan and _cost(back.cost) == _cost(choice.cost)
    payload = json.loads(open(path).read())
    assert payload["version"] == 1 and list(payload["entries"]) \
        == [f"choice|{layer.key()}|cpu"]
    with open(path, "w") as f:
        f.write('{"version": 1, "entr')
    with pytest.raises(tp.PlanCacheCorrupt):
        tp.PlanCache.load(path, strict=True)
    assert tp.PlanCache.load(path).entries == {}      # lenient: fresh
    with open(path, "w") as f:
        json.dump({"version": 2, "entries": {}}, f)
    with pytest.raises(tp.PlanCacheCorrupt, match="version"):
        tp.PlanCache.load(path, strict=True)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_plan_cache_files_cross_packages(writer, tmp_path):
    """A cache file written by either package loads in the other and
    gives back the same choices for every layer."""
    path = str(tmp_path / "plans.json")
    js = jp.ultranet_layer_specs(64) + jp.arch_layer_specs(
        "tinyllama-1.1b", smoke=True, min_size=1024)
    ts = tp.ultranet_layer_specs(64) + tp.arch_layer_specs(
        "tinyllama-1.1b", smoke=True, min_size=1024)
    (wmod, wspecs), (rmod, rspecs) = ((jp, js), (tp, ts)) \
        if writer == "jax" else ((tp, ts), (jp, js))
    written = wmod.plan_layers(wspecs, policy="cache",
                               cache=wmod.PlanCache.load(path))
    reader = rmod.PlanCache.load(path, strict=True)
    assert len(reader.entries) == len({s.key() for s in rspecs})
    for w, spec in zip(written, rspecs):
        got = reader.get_choice(spec)
        assert got is not None, spec.name
        assert rmod.plan_to_dict(got.plan) == wmod.plan_to_dict(w.plan)
    # the reader's own cache policy then re-saves an identical file
    before = open(path).read()
    rmod.plan_layers(rspecs, policy="cache", cache=reader)
    assert json.loads(open(path).read()) == json.loads(before)


def test_autotune_on_the_cpu(tmp_path):
    """Autotune times the shortlist through the port's kernels (their
    plain versions on the CPU), keys timings and the choice by the
    device type, and reuses cached timings; without a card the default
    device raises instead of timing on the CPU."""
    layer = tp.matmul_spec("p", 4, 32, 16, w_bits=4, a_bits=8)
    cache = tp.PlanCache(path=str(tmp_path / "tune.json"))
    choice = tp.autotune_layer(layer, cache=cache, top_k=2, repeats=1,
                               device="cpu")
    assert choice.measured_us is not None and choice.measured_us > 0
    assert all(k.endswith("|cpu") for k in cache.entries)
    cache.save()
    reloaded = tp.PlanCache.load(str(tmp_path / "tune.json"))
    assert reloaded.get_choice(layer, backend="cpu").plan == choice.plan
    n = len(reloaded.entries)
    tp.autotune_layer(layer, cache=reloaded, top_k=2, repeats=1,
                      device="cpu")
    assert len(reloaded.entries) == n
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.autotune_layer(layer, top_k=2, repeats=1)


def _serve_pair(arch, **kw):
    cfg = get_arch(arch).reduced()
    params = values(init_params(cfg, Rules(tp=None, fsdp=None, ep=None,
                                           batch=()),
                                jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    return (jq.serve_params(params, **kw), tq.serve_params(tparams, **kw))


def _packed(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _packed(v, f"{path}/{k}")
    elif isinstance(tree, (jq.SDVLinear, jq.BSEGConv, tq.SDVLinear,
                           tq.BSEGConv)):
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_params_auto_words_bit_identical(arch):
    """``serve_params(plan_policy="auto", rows=8)``: every packed
    container has the reference's plan, words and scales, bit for bit."""
    jtree, ttree = _serve_pair(arch, bits=4, min_size=1024, compute="sdv",
                               plan_policy="auto", rows=8)
    jl, tl = dict(_packed(jtree)), dict(_packed(ttree))
    assert sorted(jl) == sorted(tl) and jl
    for name, j in jl.items():
        t = tl[name]
        assert type(j).__name__ == type(t).__name__, name
        assert jp.plan_to_dict(j.plan) == tp.plan_to_dict(t.plan), name
        for field in ("words", "scale", "kappa", "tap_sum", "bias"):
            if hasattr(j, field):
                # values bit for bit (the reference's tap sums are int64
                # under the tests' x64 mode, the port's int32)
                a, b = np.asarray(getattr(j, field)), \
                    getattr(t, field).numpy()
                assert a.shape == b.shape and (a == b).all(), (name, field)
    # the planner's W4A8 choice is a wide DSP48E2 word, not INT32
    assert {v.plan.spec.name for v in tl.values()
            if isinstance(v, tq.SDVLinear)} == {"dsp48e2"}


def test_serve_params_cache_policy_roundtrip(tmp_path):
    """``plan_policy="cache"`` writes the choices it made and packs the
    same plans from them again; memory packing refuses planner
    policies."""
    path = str(tmp_path / "plans.json")
    kw = dict(bits=4, min_size=1024, compute="sdv", plan_policy="cache",
              plan_cache=path, rows=8)
    _, first = _serve_pair("tinyllama-1.1b", **kw)
    entries = json.load(open(path))["entries"]
    assert entries and all(k.startswith("choice|matmul:") for k in entries)
    _, second = _serve_pair("tinyllama-1.1b", **kw)
    assert {n: v.plan for n, v in _packed(first)} \
        == {n: v.plan for n, v in _packed(second)}
    with pytest.raises(ValueError, match="memory packing"):
        tq.serve_params({}, compute="memory", plan_policy="auto")


@pytest.mark.parametrize("argv", [
    ["--arch", "ultranet", "--smoke"],
    ["--arch", "tinyllama-1.1b", "--no-smoke"],
    ["--arch", "mamba2-130m", "--smoke", "--policy", "default"],
])
def test_cli_matches_reference(argv, capsys, tmp_path):
    """``python -m repro_torch.planner`` prints the reference CLI's plan
    table, line for line, and writes its JSON payload."""
    from repro.planner.__main__ import main as jmain
    from repro_torch.planner.__main__ import main as tmain
    assert jmain(argv) == 0
    want = capsys.readouterr().out
    out = str(tmp_path / "plans.json")
    assert tmain(argv + ["--json", out]) == 0
    got = capsys.readouterr().out
    assert got.replace(f"wrote {out}\n", "") == want
    payload = json.load(open(out))
    assert payload["arch"] == argv[1] and payload["layers"]
