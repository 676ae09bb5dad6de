"""CPU runs of the benchmark's cells at a tiny size: a throwaway copy of
the benchmark gains two cells (a dense prefill and an MoE decode) as new
files and entries only, and each runs through the harness on the CPU
(the kernels' plain versions), judged by the plain reference.  The
program as stated agrees with the reference; its own lower precision
(the control) and faults planted underneath it do not."""
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parent.parent
ARCH = dict(name="tiny", family="vlm", n_layers=2, d_model=128, n_heads=4,
            n_kv=2, d_ff=256, vocab=512)
PORT = dict(compute="sdv", weight_bits=4, act_bits=8, min_size=16)
CELLS = {
    "tiny.prefill": ("tiny", "tiny_prefill", "llava7b.prefill.b8",
                     ARCH, dict(kind="prefill_batches", batch=4,
                                prompt_min=20, prompt_max=40, pool=4,
                                chunk=16, s_max=40, max_batches=200,
                                check=1000)),
    "tiny.decode": ("tinymoe", "tiny_decode", "phi35moe.decode.b32",
                    dict(ARCH, name="tinymoe", family="moe", n_experts=4,
                         top_k=2),
                    dict(kind="decode_closed", batch=4, context_min=8,
                         context_max=24, s_max=64, kv_std=1.0)),
}
#: limits at this size, from the readings of the sound runs (max_gap
#: 0-0.005, route_gap 0) and of the W4A4 control (0.43-1.9, 0.014)
LIMITS = {"max_gap": 0.1, "route_gap": 0.005}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A copy of the benchmark with the tiny cells added: new files and
    new entries, no existing file edited."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (conf, mix, like, arch, traffic) in CELLS.items():
        (root / f"portbench/configs/{conf}.json").write_text(
            json.dumps({"port": dict(PORT, arch=arch)}))
        (root / f"portbench/traffic/{mix}.json").write_text(
            json.dumps(traffic))
        (root / f"portbench/limits/{cell}.json").write_text(
            json.dumps(LIMITS))
        spec["configs"].append(dict(name=conf, source="a test",
                                    file=f"portbench/configs/{conf}.json",
                                    reduced=[], why="a test"))
        spec["workloads"].append(dict(name=cell, config=conf, traffic=mix,
                                      chips=1, why="a test"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {p: p.read_bytes() for p in before}
    assert after == before
    return harness.Bench(root)


def run(bench, cell, *, seed=2**31 + 11, trace=False, act_bits=None):
    return harness.run_cell(bench, cell, seed=seed, seconds=0.5,
                            trace=trace, device="cpu",
                            t_start=time.perf_counter(), act_bits=act_bits)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_agrees_with_the_reference(bench, cell):
    out = run(bench, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    want = {m["name"] for m in bench.cell(cell)["end_to_end"]}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails(bench, cell):
    """The program at W4A4, its own lower precision, is not correct."""
    out = run(bench, cell, act_bits=4)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_run_line(bench, cell):
    """A traced run keeps the line's keys and adds the breakdown; on the
    CPU no device metric is written."""
    out = run(bench, cell, trace=True)
    assert out["correct"]
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["metrics"] == {}
    assert set(out["device"]) >= {"busy_s", "window_s"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _alter_token(models, monkeypatch):
    """The first-row token of the first step in the window made another
    one."""
    orig = models.decode_step
    calls = []

    def step(cfg, params, cache, tokens, advance=None):
        logits, cache = orig(cfg, params, cache, tokens, advance)
        calls.append(1)
        if len(calls) == 2:              # the warm-up, then the window
            logits = logits.clone()
            best = logits[0, -1, :cfg.vocab].argmax()
            logits[0, -1, (best + cfg.vocab // 2) % cfg.vocab] += 1e3
        return logits, cache
    monkeypatch.setattr(models, "decode_step", step)


def _state_unchanged(models, monkeypatch):
    """Every step leaves the cache as it found it: nothing is written."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "_put", lambda *a, **k: None)


def _half_batch(models, monkeypatch):
    """The second half of the batch left out: its rows take the logits
    of the first half."""
    orig = models.decode_step

    def step(cfg, params, cache, tokens, advance=None):
        logits, cache = orig(cfg, params, cache, tokens, advance)
        h = logits.shape[0] // 2
        return torch.cat([logits[:h], logits[:logits.shape[0] - h]]), cache
    monkeypatch.setattr(models, "decode_step", step)


@pytest.mark.parametrize("fault", [_alter_token, _state_unchanged,
                                   _half_batch])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_caught(bench, cell, fault, monkeypatch):
    """A run with the timed path broken underneath (one chip: no
    exchange between chips to leave out) is not correct."""
    from repro_torch import models
    fault(models, monkeypatch)
    out = run(bench, cell)
    assert not out["correct"], out["checks"]


def test_routes_not_recorded_fail(bench, monkeypatch):
    """An MoE program that no longer routes through ``moe_route`` leaves
    its choices unread: the run is not correct."""
    from portbench import program
    import contextlib

    @contextlib.contextmanager
    def nothing():
        yield []
    monkeypatch.setattr(program, "expert_choices", nothing)
    out = run(bench, "tiny.decode")
    assert not out["correct"]
    assert out["checks"]["route_gap"]["value"] != \
        out["checks"]["route_gap"]["value"]          # NaN
