"""The benchmark's parts on the CPU: the frozen counts against hand
counts, the traffic generators by seed, every cell, configuration, mix,
limit and metric found by its name, the command line without a card,
and the import rule (no JAX, no JAX package; no port in the
reference)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, roofline as R
from portbench.reference import quant as Q

ROOT = Path(__file__).resolve().parent.parent
FOLDER = ROOT / "portbench"
BENCH = harness.Bench(ROOT)
SPEC = BENCH.spec()
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in SPEC["configs"]}
LLAVA = CONFIGS["llava-next-mistral-7b.sdv"]["port"]["arch"]
PHI = CONFIGS["phi3.5-moe.sdv"]["port"]["arch"]


def test_layer_weights_by_hand():
    # llava: q 4096x4096, k and v 4096x1024, o 4096x4096, MLP 3 x
    # 4096x14336; phi: the same attention, 2 of 16 experts of 3 x
    # 4096x6400, the 4096x16 router
    assert R.layer_weights(LLAVA) == 2 * 4096 * 4096 + 2 * 4096 * 1024 \
        + 3 * 4096 * 14336 == 218_103_808
    assert R.layer_weights(PHI) == 2 * 4096 * 4096 + 2 * 4096 * 1024 \
        + 2 * 3 * 4096 * 6400 + 4096 * 16 == 199_294_976


def test_model_flops_by_hand():
    # one phi token at position 9 (10 keys) with its logits
    f = R.model_flops(PHI, tokens=1, context_sum=10, logit_rows=1)
    assert f == 2 * 199_294_976 * 32 + 4 * 32 * 128 * 10 * 32 \
        + 2 * 4096 * 32064
    assert R.context_sum(9, 1) == 10
    assert R.context_sum(0, 4) == 1 + 2 + 3 + 4


def test_b2_by_hand():
    # llava's q projection at 4096 rows, W4A8, bf16 out
    c = R.b2_call(4096, 4096, 4096, 4, 8)
    assert c["ops"] == 2 * 4096 ** 3
    assert c["bytes"] == 4096 * 4096 + 4096 * 4096 // 2 + 2 * 4096 * 4096
    # a chunk of 4096 rows with 3000 real ones: only the real rows count
    per_layer = sum(max(2 * 3000 * k * n / 1979e12,
                        (3000 * k + k * n // 2 + 2 * 3000 * n) / 3.35e12)
                    for k, n in [(4096, 4096), (4096, 1024), (4096, 1024),
                                 (4096, 4096), (4096, 14336),
                                 (4096, 14336), (14336, 4096)])
    assert R.b2_step_bound_s(LLAVA, 4096, 3000, 4, 8) == pytest.approx(
        32 * per_layer, rel=1e-12)
    assert R.b2_step_bound_s(LLAVA, 8, 8, 4, 8) == 0.0    # B1's rows
    # phi's attention at a decode step's 32 rows: bytes bound (the W4
    # weights, read once)
    att = sum((32 * k + k * n // 2 + 2 * 32 * n) / 3.35e12
              for k, n in [(4096, 4096), (4096, 1024), (4096, 1024),
                           (4096, 4096)])
    assert R.b2_step_bound_s(PHI, 32, 32, 4, 8) == pytest.approx(
        32 * att, rel=1e-12)


def test_b7_by_hand():
    # one phi gate bank: 16 x 4096 x 6400 fields, 8 a word
    assert R.b7_bank_bytes(16, 4096, 6400, 4) == \
        16 * 4096 * 800 * 4 + 16 * 6400 * 4 + 16 * 4096 * 6400 * 2 \
        == 1_048_985_600
    wo = 16 * 6400 * 512 * 4 + 16 * 4096 * 4 + 16 * 6400 * 4096 * 2
    assert R.b7_step_bound_s(PHI, 4) == pytest.approx(
        32 * (2 * 1_048_985_600 + wo) / 3.35e12, rel=1e-12)
    assert R.b7_step_bound_s(LLAVA, 4) == 0.0


def test_quant_rule():
    x = torch.tensor([[0.5, -1.0, 0.25, 0.0]])
    q, s = Q.quantize(x, 8, dim=-1)
    assert s.item() == pytest.approx(1.0 / 127)
    assert q.tolist() == [[64.0, -127.0, 32.0, 0.0]]     # 63.5 -> 64 (even)
    codes, scale = Q.weight_codes(torch.tensor([[0.7], [-0.1]]), 4)
    assert codes[:, 0].tolist() == [7.0, -1.0] and scale.shape == (1,)


def _kind(name):
    return BENCH.module("kinds", name)


def test_prefill_lengths_by_seed():
    mix = BENCH.data("traffic", "prefill_1k_2k_b8")
    kind = _kind("prefill_batches")
    a = kind.lengths(mix, 2**31 + 5, 64)
    assert a == kind.lengths(mix, 2**31 + 5, 64)
    b = kind.lengths(mix, 7, 64)
    assert a != b
    # every seed serves the same lengths, a batch at a time
    for i in range(0, 64, mix["batch"]):
        assert sorted(a[i:i + 8]) == sorted(b[i:i + 8]) \
            == kind.pool_lengths(mix)
    assert min(a) == mix["prompt_min"] and max(a) == mix["prompt_max"]


def test_decode_contexts_by_seed():
    mix = dict(BENCH.data("traffic", "decode_ctx512_2048_b32"), s_max=24,
               batch=4, context_min=4, context_max=16)
    kind = _kind("decode_closed")
    a = kind.contexts(mix, 2**31 + 5)
    assert a == kind.contexts(mix, 2**31 + 5)
    assert sorted(a) == sorted(kind.contexts(mix, 99)) == [4, 8, 12, 16]
    arch = dict(PHI, n_kv=2, head_dim=8)
    one = kind.context_kv(arch, mix, a, 3, 0, "cpu")
    two = kind.context_kv(arch, mix, a, 3, 0, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    other = kind.context_kv(arch, mix, a, 4, 0, "cpu")
    assert not torch.equal(one[0], other[0])
    for row, n in enumerate(a):                      # zero past the context
        assert one[0][row, n:].abs().sum() == 0
        assert one[0][row, :n].abs().sum() > 0


def test_weights_by_seed():
    from portbench import weights as W
    arch = dict(PHI, n_layers=1, d_model=64, n_heads=4, n_kv=2, d_ff=32,
                vocab=100, n_experts=4)
    a = W.draw_layer(arch, 2**31 + 9, 0, "cpu")
    b = W.draw_layer(arch, 2**31 + 9, 0, "cpu")
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    c = W.draw_layer(arch, 2**31 + 10, 0, "cpu")
    assert not torch.equal(a["attn/wq/kernel"], c["attn/wq/kernel"])
    assert a["moe/wi_gate"].shape == (4, 64, 32)
    assert W.vocab_padded(32064) == 32128


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_by_name(cell):
    """Each cell's configuration, mix, kind, limits and metric readers
    load from their own files, and every metric it reports is one it
    lists."""
    c = BENCH.cell(cell)
    assert c["config"]["port"]["compute"] == "sdv"
    kind = BENCH.module("kinds", c["traffic"]["kind"])
    assert hasattr(kind, "Cell")
    assert c["limits"] and all(v > 0 for v in c["limits"].values())
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(BENCH.module("metrics", m["name"]).read)
        assert m["moves"] in names


#: ArchConfig fields a configuration sets to the published value where
#: the registry's entry holds another, and the published key of each
PUBLISHED = {"vocab": "vocab_size", "rope_theta": "rope_theta"}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_is_the_registry_model(name):
    """A configuration runs the registry's model as it stands, but for
    the vocabulary and the RoPE theta, which follow the published
    configuration."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from portbench import program
    conf = CONFIGS[name]
    cfg = program.arch_config(conf)
    reg = get_arch(cfg.name)
    published = conf.get("text_config", conf)
    for f in dataclasses.fields(cfg):
        ours, theirs = getattr(cfg, f.name), getattr(reg, f.name)
        if ours != theirs:
            assert f.name in PUBLISHED, f.name
            assert ours == published[PUBLISHED[f.name]], f.name


def test_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    for entry in SPEC["configs"]:
        assert (ROOT / entry["file"]).is_file()
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert (FOLDER / "metrics" / f"{m['name']}.py").is_file()
    for w in SPEC["workloads"]:
        assert (FOLDER / "limits" / f"{w['name']}.json").is_file()
        assert (FOLDER / "traffic" / f"{w['traffic']}.json").is_file()


def test_command_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(FOLDER / "run.py"), "--workload",
         SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_and_no_port_in_the_reference():
    """Top-level names compared whole: ``repro_torch`` is not
    ``repro``."""
    for path in FOLDER.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if "reference" in path.relative_to(FOLDER).parts:
            assert "repro_torch" not in tops, path


def test_the_port_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['.', 'src']; "
            "from portbench import harness, program, weights; "
            "import repro_torch.models, repro_torch.kernels.ops; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr


def test_readers_on_a_made_up_run():
    """``step_mfu`` reads the untraced stretch's work over its seconds;
    B2's bound counts each call's real rows; ``moe_dev_ms`` reads only
    the stretch traced with host ops, and nothing where there is none."""
    from portbench import readers, trace as T
    ev = [T.DeviceEvent("sdv_gemm_kernel", 0, 10 ** 9, None)]
    tr = T.Trace(0, 2 * 10 ** 9, ev, {}, None)
    port = CONFIGS["llava-next-mistral-7b.sdv"]["port"]
    timed = {"seconds": 4.0, "tokens": 1000, "context_sum": 500_500,
             "logit_rows": 1}
    work = {"calls": [[4096, 3000, 1], [8, 8, 1]]}
    run = harness.LayerRun(arch=LLAVA, port=port, traffic={}, work=work,
                           trace=tr, timed=timed)
    flops = R.model_flops(LLAVA, tokens=1000, context_sum=500_500,
                          logit_rows=1)
    assert readers.step_mfu_pct(run) == pytest.approx(
        100 * flops / (4.0 * 989e12))
    assert readers.b2_roofline_pct(run) == pytest.approx(
        100 * R.b2_step_bound_s(LLAVA, 4096, 3000, 4, 8) / 1.0)
    assert readers.idle_pct(run) == pytest.approx(50.0)
    assert readers.moe_dev_ms(run) is None              # no banks
    phi = dict(run.__dict__, arch=PHI, work={"calls": [[32, 32, 2]]})
    phi_run = harness.LayerRun(**phi)
    assert readers.moe_dev_ms(phi_run) is None          # no host stretch
    b7 = [T.DeviceEvent("unpack_dequant_kernel", 0, 3 * 10 ** 7, None)]
    phi_run.host = harness.LayerRun(**dict(
        phi, trace=T.Trace(0, 10 ** 9, b7, {}, None)))
    assert readers.moe_dev_ms(phi_run) == pytest.approx(15.0)
