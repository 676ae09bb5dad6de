"""The torch port's dry run (``repro_torch.launch.dryrun``) against the
JAX package's: the reference test's six cells (tinyllama-1.1b,
mamba2-130m and phi3.5-moe reduced in width, ``train_4k`` and
``decode_32k`` at seq 64, batch 8) built on a (4, 2) ("data", "model")
``DeviceMesh`` over torch's fake process group give argument and
sharding trees of equal leaf counts — the reference's counts, 38/22,
44/21 and 41/23 — with every argument on the ``meta`` device; the
``long_500k`` skip set equals the reference's; a cell's numbers are
reckoned (flops > 0, per-device argument bytes from the placements); a
train cell's one-rank memory, bytes and collectives are reckoned on
``meta`` DTensors (the peak holds the arguments, ``fsdp`` gathers and
reduce-scatters, a one-rank mesh has no collective, remat lowers the
peak), and so are a decode cell's (the reference test's three and
reduced recurrentgemma-2b's ``long_500k``: no collective moves a cache
leaf, a one-rank mesh has none); the CLI runs a production-mesh cell
(256 fake ranks) and a skipped one."""
import dataclasses
import json

import pytest

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import ARCHS as JARCHS

from repro_torch import tree
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import Sharding
from repro_torch.models import PartitionSpec

CELLS = {("tinyllama-1.1b", "train_4k"): 38,
         ("tinyllama-1.1b", "decode_32k"): 22,
         ("mamba2-130m", "train_4k"): 44,
         ("mamba2-130m", "decode_32k"): 21,
         ("phi3.5-moe-42b-a6.6b", "train_4k"): 41,
         ("phi3.5-moe-42b-a6.6b", "decode_32k"): 23}


@pytest.fixture
def mesh():
    from torch.distributed.device_mesh import init_device_mesh
    with DR.fake_world(8):
        yield init_device_mesh("cpu", (4, 2),
                               mesh_dim_names=("data", "model"))


def _cell(arch, shape_name):
    cfg = dataclasses.replace(get_arch(arch).reduced(), name=arch)
    return cfg, dataclasses.replace(SHAPES[shape_name], seq_len=64,
                                    global_batch=8)


@pytest.mark.parametrize("arch,shape_name", sorted(CELLS))
def test_cells_build_with_matching_leaf_counts(mesh, arch, shape_name):
    cfg, shape = _cell(arch, shape_name)
    rules, fn, args, in_sh, donate = DR.build_cell(cfg, shape, mesh)
    leaves = tree.leaves(args)
    shardings = tree.leaves(in_sh)
    assert len(leaves) == len(shardings) == CELLS[arch, shape_name]
    assert all(x.device.type == "meta" for x in leaves)
    assert all(isinstance(s, Sharding) and len(s.placements) == 2
               for s in shardings)
    assert rules.tp_degree == 2 and rules.batch_degree == 4
    assert donate == ((0, 1) if shape.kind == "train" else (1,))


def test_long_context_skips_match_reference():
    port = {a.name for a in ARCHS.values()
            if not a.shape_supported(SHAPES["long_500k"])[0]}
    ref = {a.name for a in JARCHS.values()
           if not a.shape_supported(JSHAPES["long_500k"])[0]}
    assert port == ref
    assert "qwen2.5-32b" in port
    assert "mamba2-130m" not in port and "recurrentgemma-2b" not in port


def test_batch_one_degrades_to_a_replicated_batch(mesh):
    cfg = get_arch("mamba2-130m").reduced()
    shape = dataclasses.replace(SHAPES["long_500k"], seq_len=64)
    rules, _, args, in_sh, _ = DR.build_cell(cfg, shape, mesh)
    assert rules.batch == () and rules.batch_degree == 1
    assert in_sh[-1]["tokens"].spec == PartitionSpec(None, None)


def _train_cell(**over):
    """Reduced tinyllama-1.1b's ``train_4k`` cell at seq 64 with ``fsdp``
    and a global batch of 16: 4 microbatches of one row a data rank."""
    cfg, shape = _cell("tinyllama-1.1b", "train_4k")
    return (dataclasses.replace(cfg, fsdp=True, **over),
            dataclasses.replace(shape, global_batch=16))


def test_measure_cell_reckons_and_leaves_no_invented_numbers(mesh):
    """A train cell's one-rank fields, reckoned on the 8-rank mesh: the
    peak holds the arguments, the temporaries are the rest; the
    ``fsdp`` parameters are gathered and their gradients reduce-scattered;
    rematerialization lowers the peak."""
    res = {}
    for remat in (True, False):
        cfg, shape = _train_cell(remat=remat,
                                 remat_group=2 if remat else 0)
        r = DR.measure_cell(cfg, shape, mesh)
        assert r["status"] == "ok" and r["devices"] == 8
        assert "null_reasons" not in r
        _, _, args, in_sh, _ = DR.build_cell(cfg, shape, mesh)
        assert r["argument_bytes"] == DR.per_device_bytes(args, in_sh)
        assert r["peak_bytes"] >= r["argument_bytes"] > 0
        assert r["temp_bytes"] == r["peak_bytes"] - r["argument_bytes"]
        assert r["output_bytes"] > 0 and r["bytes_per_device"] > 0
        coll = r["collectives"]
        assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
        assert r["collective_bytes_per_device"] == sum(coll.values())
        res[remat] = r
    assert res[True]["peak_bytes"] < res[False]["peak_bytes"]


def test_one_rank_cell_has_no_collectives():
    from torch.distributed.device_mesh import init_device_mesh
    cfg, shape = _train_cell()
    with DR.fake_world(1):
        one = init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
        r = DR.measure_cell(cfg, shape, one)
    assert r["collectives"] == {} and r["collective_bytes_per_device"] == 0
    assert r["peak_bytes"] > r["argument_bytes"] > 0


#: the reference test's decode cells, and reduced recurrentgemma-2b's
#: long_500k (batch 1: a replicated batch)
DECODE_CELLS = [("tinyllama-1.1b", "decode_32k"),
                ("mamba2-130m", "decode_32k"),
                ("phi3.5-moe-42b-a6.6b", "decode_32k"),
                ("recurrentgemma-2b", "long_500k")]


def _decode_cell(arch, shape_name):
    cfg, shape = _cell(arch, shape_name)
    if shape_name == "long_500k":
        shape = dataclasses.replace(shape, global_batch=1)
    return cfg, shape


@pytest.mark.parametrize("arch,shape_name", DECODE_CELLS)
def test_decode_cell_is_reckoned_without_moving_the_cache(mesh, arch,
                                                          shape_name):
    """A decode step's one-rank memory, bytes and collectives, reckoned
    on meta DTensors as a train cell's: the peak holds the arguments; no
    collective moves a cache leaf (``cache_collectives``: none has an
    operand of the shape of a layer's local cache shard)."""
    cfg, shape = _decode_cell(arch, shape_name)
    rk = DR.RankReckoner()
    res = DR.measure_cell(cfg, shape, mesh, rk)
    assert res["status"] == "ok" and res["devices"] == 8
    assert res["flops"] > 0 and res["flops_per_device"] == res["flops"] / 8
    _, _, args, in_sh, _ = DR.build_cell(cfg, shape, mesh)
    assert res["argument_bytes"] == DR.per_device_bytes(args, in_sh)
    assert res["peak_bytes"] >= res["argument_bytes"] > 0
    assert res["temp_bytes"] == res["peak_bytes"] - res["argument_bytes"]
    assert res["output_bytes"] > 0 and res["bytes_per_device"] > 0
    assert res["collective_bytes_per_device"] == sum(
        res["collectives"].values())
    assert DR.cache_collectives(rk, args[1], in_sh[1]) == []
    assert len(rk.operands) > 0         # the fake mesh's gathers were seen
    if arch == "tinyllama-1.1b":
        # the KV cache [L, B, S, KV, hd] int8 shards B over "data" (4) and
        # the KV heads over "model" (2): an eighth a rank
        k = args[1]["k"]
        assert DR.per_device_bytes(k, in_sh[1]["k"]) == k.numel() // 8


@pytest.mark.parametrize("arch,shape_name", DECODE_CELLS)
def test_one_rank_decode_cell_has_no_collectives(arch, shape_name):
    from torch.distributed.device_mesh import init_device_mesh
    cfg, shape = _decode_cell(arch, shape_name)
    with DR.fake_world(1):
        one = init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
        r = DR.measure_cell(cfg, shape, one)
    assert r["collectives"] == {} and r["collective_bytes_per_device"] == 0
    assert r["peak_bytes"] >= r["argument_bytes"] > 0


def test_cli_production_mesh_cell_and_skip(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    assert DR.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                    "--mesh", "single", "--out", str(out)]) == 0
    assert DR.main(["--arch", "qwen2.5-32b", "--shape", "long_500k",
                    "--mesh", "both", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["ok", "skipped", "skipped"]
    assert recs[0]["devices"] == 256 and recs[0]["mesh"] == "16x16"
    assert "1 ok, 0 skipped" in capsys.readouterr().out
