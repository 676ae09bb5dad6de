"""The torch port's examples (``examples_torch/``) on the CPU at their
smallest settings, each through its ``main``: quickstart as it is,
``ultranet_bseg --size 32``, ``serve_packed`` with a short prompt,
``serve_engine`` with 4 requests and 3 calibration steps, and
``train_lm --small --steps 3`` (then resumed) into a temporary
checkpoint directory.

Every printed number that does not depend on the weights' draws or the
clock is held against the value the reference's example prints,
computed by the reference's own functions: the densities, lanes, tap
and sample counts of the quickstart, UltraNet's conv routes, multiply
counts and Tab. IV lines, the weight bytes of ``serve_params``
(``jax.eval_shape`` of the reference's, nothing compiled), the
engine's request stream and its plan utilization, and the parameter
count of the training model.  Without ``--device cpu`` (and without a
card) every example raises instead of running on the CPU.
"""
import importlib.util
import math
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch
from repro.core import (DSP48E2, INT32, bseg_density, plan_bseg, plan_sdv,
                        sdv_density)
from repro.finnlite import ultranet_tables
from repro.models import Rules, init_params, serve_params, values
from repro.models import ultranet as jU
from repro.serving.metrics import packed_utilization

from repro_torch.train import checkpoint

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "serve_engine", "serve_packed", "train_lm",
            "ultranet_bseg")
RULES = Rules(tp=None, fsdp=None, ep=None, batch=())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small CPU tensors (more only contend
    with the test workers running beside this one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example(name):
    return _load(ROOT / "examples_torch" / f"{name}.py")


def _run(name, args, capsys):
    assert example(name).main(args) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_to_fall_back_to_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example(name).main([])


def test_quickstart(capsys):
    out = _run("quickstart", ["--device", "cpu"], capsys)
    plan = plan_sdv(DSP48E2, 4, 4, park_sign_bits=True)
    planb = plan_bseg(DSP48E2, 4, 4)
    kplan = plan_sdv(INT32, 4, 8, park_sign_bits=True)
    for line in (
            f"SDV  density, DSP48E2, INT8: {sdv_density(DSP48E2, 8, 8)} "
            "(paper: 2)",
            f"SDV  density, DSP48E2, INT4: {sdv_density(DSP48E2, 4, 4)}",
            f"BSEG density, DSP48E2, INT4: {bseg_density(DSP48E2, 4, 4)}",
            f"SDV  density, int32 word, W4A4: {sdv_density(INT32, 4, 4)}",
            f"SDV matmul on DSP48E2: {plan.n} MACs/wide multiply "
            f"(lane={plan.lane} bits), word = 2x int32 limbs, "
            "bit-exact = True",
            f"BSEG conv on DSP48E2: n_k={planb.n_k} x n_i={planb.n_i} = "
            f"{planb.density} MACs/multiply, guard bias "
            f"2^{planb.lane - 1}, bit-exact = True",
            f"sdv_matvec (plain torch version on the CPU): {kplan.n} "
            "MACs/int32-multiply"):
        assert line in out, line


def test_ultranet_bseg(capsys):
    out = _run("ultranet_bseg", ["--size", "32", "--device", "cpu"], capsys)
    assert "head (1, 2, 2, 36), BSEG bit-exact vs integer conv oracle: " \
        "True" in out
    routes = jU.ultranet_conv_routes(32, 32)
    assert "conv dispatch: " + " ".join(
        f"L{i}:{r}" for i, r in enumerate(routes)) in out
    m = jU.ultranet_multiplies(416, 416, mode="bseg")
    n = jU.ultranet_multiplies(416, 416, mode="naive")
    t4m = ultranet_tables()["tab4"]["model"]
    for line in (f"416x416 frame: {m['total_macs'] / 1e6:.0f}M MACs",
                 f"naive multiplies : {n['total_mults'] / 1e6:.0f}M",
                 f"BSEG  multiplies : {m['total_mults'] / 1e6:.0f}M "
                 f"({m['density_achieved']:.2f} MACs/multiply",
                 f"FINN baseline: {t4m['finn_lut']} LUT / "
                 f"{t4m['finn_dsp']} DSP",
                 f"BSEG         : {t4m['bseg_lut']} LUT / "
                 f"{t4m['bseg_dsp']} DSP",
                 f"LUT reduction: "
                 f"{1 - t4m['bseg_lut'] / t4m['finn_lut']:.0%}"):
        assert line in out, line


def _tree_bytes(tree):
    return sum(leaf.size * leaf.dtype.itemsize
               for leaf in jax.tree_util.tree_leaves(tree))


def test_serve_packed(capsys):
    out = _run("serve_packed", ["--device", "cpu", "--prompt-len", "4",
                                "--new-tokens", "3"], capsys)
    cfg = get_arch("tinyllama-1.1b").reduced()
    params = values(init_params(cfg, RULES, None))      # shapes only
    q = jax.eval_shape(lambda p: serve_params(p, bits=4, min_size=1024),
                       params)
    b, bq = _tree_bytes(params), _tree_bytes(q)
    assert (f"weights: bf16 {b / 2**20:.2f} MiB -> packed W4 "
            f"{bq / 2**20:.2f} MiB ({b / bq:.2f}x smaller") in out
    for label in ("packed W4", "bf16     "):
        tail = re.search(rf"{label}: +[0-9.]+ tok/s +\(greedy tail: "
                         r"\[([0-9 ]+)\]\)", out)
        assert tail and len(tail.group(1).split()) == 3, label
    mae, span = map(float, re.search(
        r"logit MAE packed-vs-bf16: ([0-9.]+) \(range ±([0-9.]+)\)",
        out).groups())
    assert math.isfinite(mae) and 0 < mae < span


class _Recorder:
    """Stands in for an engine: records what ``submit_stream`` submits."""

    def __init__(self):
        self.got = []

    def clock(self):
        return 0.0

    def submit(self, prompt, new_tokens, deadline):
        self.got.append((len(prompt), new_tokens))
        return len(self.got) - 1


def test_serve_engine(capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)          # no plan-cache file: policy auto
    out = _run("serve_engine", ["--device", "cpu", "--requests", "4",
                                "--train-steps", "3"], capsys)
    cfg = get_arch("tinyllama-1.1b").reduced()
    # the reference example's request stream, drawn by its own code
    ref_example = _load(ROOT / "examples" / "serve_engine.py")
    rec = _Recorder()
    ref_example.submit_stream(rec, cfg, 4, np.random.default_rng(0))
    for rid, (pl, nt) in enumerate(rec.got):
        assert re.search(rf"rid +{rid}  bucket b4\.s(24|48)  prompt +{pl} "
                         rf"-> +{nt} tokens", out), (rid, pl, nt)
    assert "4 requests," in out
    # the reference's plan utilization of the bucket's tree (the plans
    # depend on the shapes alone)
    params = values(init_params(cfg, RULES, None))
    util = packed_utilization(jax.eval_shape(
        lambda p: serve_params(p, bits=4, min_size=1024, compute="sdv",
                               act_bits=8, conv_bseg=True,
                               plan_policy="auto", rows=4), params), 4)
    assert (f"{util['kernel_routed_layers']}/{util['packed_layers']} "
            "packed layers on kernel routes, density "
            f"{util['density_achieved']:.2f} MACs/multiply") in out
    assert "outputs bit-identical to plain decode: True" in out
    rows = re.findall(r"n=(\d+) +sdv n=\d+ L=\d+ +n=(\d+) +sdv n=\d+ L=\d+ "
                      r"+DENSER", out)
    assert len(rows) == util["packed_layers"]
    assert {(int(t), int(d)) for t, d in rows} == {(3, 4)}


def test_train_lm(capsys, tmp_path):
    ck = str(tmp_path / "ck")
    out = _run("train_lm", ["--small", "--steps", "3", "--device", "cpu",
                            "--ckpt-dir", ck], capsys)
    cfg = _load(ROOT / "examples" / "train_lm.py").CFG.reduced()
    n = sum(x.size for x in jax.tree_util.tree_leaves(
        values(init_params(cfg, RULES, None))))
    assert f"model {cfg.name}: {n / 1e6:.1f}M params" in out
    loss = float(re.search(r"step +1  loss ([0-9.]+)", out).group(1))
    assert math.isfinite(loss) and abs(loss - math.log(cfg.vocab)) < 0.5
    assert checkpoint.latest_step(ck) == 3
    out = _run("train_lm", ["--small", "--steps", "4", "--device", "cpu",
                            "--ckpt-dir", ck, "--resume"], capsys)
    assert "resumed from step 3" in out and "step    4  loss" in out
    assert checkpoint.latest_step(ck) == 4
