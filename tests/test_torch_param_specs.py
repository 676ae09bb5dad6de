"""The port's sharding metadata against the JAX package's: parameter,
cache and serve spec trees at full width for every registered arch.

``models.param_specs`` (the port's ``init_params`` on the ``meta``
device under ``Rules``: nothing is drawn or allocated) must equal the
reference's ``specs(init_params(cfg, rules, None))`` leaf for leaf, with
the same shapes and dtypes, under the rules of the single-pod (16, 16)
and multi-pod (2, 16, 16) production meshes with each arch's ``fsdp``;
``cache_specs`` the reference's ``specs(init_cache(..., abstract=True))``
at TP degrees 1, 2 and 16 (each branch of the KV-axis choice: KV heads,
head_dim, none); ``serve_param_specs`` the reference's over the same
trees.  The rules come from each package's ``rules_for_mesh`` on a mesh
stand-in (only the axis names and sizes are read), and must agree.  The
axes are metadata only: ``init_params`` draws the same values with and
without rules.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.launch import mesh as jmesh
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import quantized as jq
from repro.models.param import Rules as JRules
from repro.models.param import specs as j_specs
from repro.models.param import values as j_values

from repro_torch import tree
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import mesh as tmesh
from repro_torch.models import (PackedLinear, PartitionSpec, Rules,
                                cache_specs, init_cache, init_params,
                                param_specs, serve_param_specs, specs,
                                values)
from repro_torch.models.param import is_spec

MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}


class TorchMesh:
    """A stand-in for a ``DeviceMesh``: dimension names and sizes."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = names, shape


class JaxMesh:
    """A stand-in for a ``jax.sharding.Mesh``: axis names and sizes."""

    def __init__(self, names, shape):
        self.axis_names, self.shape = names, dict(zip(names, shape))


def _rules(mesh_name, fsdp):
    names, shape = MESHES[mesh_name]
    t = tmesh.rules_for_mesh(TorchMesh(names, shape), fsdp=fsdp)
    j = jmesh.rules_for_mesh(JaxMesh(names, shape), fsdp=fsdp)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    return t, j


def _flat(t):
    """{path: leaf} of a nested dict tree."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (jq.PackedLinear, PackedLinear)):
            walk(node.words, path + ("words",))
            walk(node.scale, path + ("scale",))
            out[path + ("bits", "d_out")] = (node.bits, node.d_out)
        else:
            out[path] = node
    walk(t, ())
    return out


def _entries(spec):
    """A spec's entries, a one-name tuple as the name: JAX's
    PartitionSpec stores ("data",) as "data", the same sharding."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _same_specs(port, ref):
    tp, jp = _flat(port), _flat(ref)
    assert tp.keys() == jp.keys()
    for k in tp:
        if k[-2:] == ("bits", "d_out"):
            assert tp[k] == jp[k], k
        else:
            assert isinstance(tp[k], PartitionSpec), k
            assert _entries(tp[k]) == _entries(jp[k]), (k, tp[k], jp[k])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch, mesh_name):
    cfg = ARCHS[arch]
    trules, jrules = _rules(mesh_name, cfg.fsdp)
    ref = j_init_params(JARCHS[arch], jrules, None)
    _same_specs(param_specs(cfg, trules), j_specs(ref))
    # the same shapes and dtypes, on the meta device (nothing allocated)
    vals = _flat(values(init_params(cfg, device="meta", rules=trules)))
    rvals = _flat(j_values(ref))
    assert vals.keys() == rvals.keys()
    for k, v in vals.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(rvals[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(rvals[k].dtype), k


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_param_specs_match_reference(arch):
    cfg = ARCHS[arch]
    trules, jrules = _rules("single", cfg.fsdp)
    tp = init_params(cfg, device="meta", rules=trules)
    jp = j_init_params(JARCHS[arch], jrules, None)
    bits = cfg.serve_weight_bits
    _same_specs(serve_param_specs(values(tp), specs(tp), bits),
                jq.serve_param_specs(j_values(jp), j_specs(jp), bits))


@pytest.mark.parametrize("tp_degree", [1, 2, 16])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_reference(arch, tp_degree):
    cfg = ARCHS[arch]
    trules = Rules(tp_degree=tp_degree, batch_degree=16)
    jrules = JRules(**dataclasses.asdict(trules))
    ref = j_init_cache(JARCHS[arch], jrules, 16, 64, abstract=True)
    _same_specs(cache_specs(cfg, trules, 16, 64), j_specs(ref))
    cache = init_cache(cfg, 16, 64, device="meta")
    rvals = j_values(ref)
    assert cache.keys() == rvals.keys()
    for k, v in cache.items():
        assert tuple(v.shape) == tuple(rvals[k].shape), k


def test_cache_kv_axis_follows_tp_degree():
    """tinyllama (4 KV heads of 64): TP 2 shards the heads, TP 16 the
    head_dim, TP 128 neither."""
    cfg = ARCHS["tinyllama-1.1b"]
    got = {tp: tuple(cache_specs(cfg, Rules(tp_degree=tp), 8, 16)["k"])
           for tp in (2, 16, 128)}
    assert got == {2: (None, ("data",), None, "model", None),
                   16: (None, ("data",), None, None, "model"),
                   128: (None, ("data",), None, None, None)}


def test_rules_resolve_and_refuse_unknown_axis():
    r = Rules(fsdp="data", batch=("pod", "data"), tp_degree=16)
    assert r.resolve(("fsdp", "tp", None, "ep", "batch")) == PartitionSpec(
        "data", "model", None, "model", ("pod", "data"))
    assert r.batch_spec(None) == PartitionSpec(("pod", "data"), None)
    assert Rules(batch=()).resolve(("batch",)) == PartitionSpec(None)
    with pytest.raises(ValueError, match="unknown logical axis"):
        r.resolve(("heads",))
    assert tree.leaves({"a": PartitionSpec(None, "model")}, is_spec) == [
        PartitionSpec(None, "model")]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m",
                                  "recurrentgemma-2b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_rules_leave_the_draws_unchanged(arch):
    cfg = ARCHS[arch].reduced()
    plain = init_params(cfg, seed=5, device="cpu")
    with_rules = values(init_params(cfg, seed=5, device="cpu",
                                    rules=Rules(tp_degree=2)))
    a, b = tree.leaves(plain), tree.leaves(with_rules)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert all(np.isfinite(x.float().numpy()).all() for x in a)
