"""The torch port stands alone: no module of ``repro_torch``, no file of
``examples_torch/``, and not ``chip_smoke.py``, imports jax or the
``repro`` package, importing them
builds no kernel, and an entry point called without a device raises on
a machine without CUDA instead of quietly running on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["repro"] = None        # ... and so does `import repro`
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
import importlib.util, pathlib
examples = sorted(pathlib.Path(sys.argv[1], "examples_torch").glob("*.py"))
assert len(examples) == 5, examples
for path in examples:
    spec = importlib.util.spec_from_file_location(f"ex_{path.stem}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from repro_torch.kernels import build
assert build.build_seconds == {}, build.build_seconds
assert not any(k.split(".")[0] in ("jax", "jaxlib", "repro")
               for k, v in sys.modules.items() if v is not None)
print(len(names))
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(ROOT)],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 69      # every module imported


def _entry_points():
    from repro_torch import planner
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import serve, train, ultranet
    from repro_torch.train import loop
    from repro_torch.train.qat import QATRunConfig, run_qat
    from repro_torch.serving import Engine, loadgen, spec
    from repro_torch.models import (init_cache, init_params, init_ultranet,
                                    opt_state_from_numpy, packed_from_numpy,
                                    params_from_numpy, ultranet_forward,
                                    ultranet_params_from_numpy)
    cfg = get_arch("tinyllama-1.1b").reduced()
    ssm = get_arch("mamba2-130m").reduced()
    hybrid = get_arch("recurrentgemma-2b").reduced()
    cpu_params = init_ultranet(0, device="cpu")
    return {
        "init_params": lambda: init_params(cfg),
        "init_cache": lambda: init_cache(cfg, 2, 8),
        "init_params_ssm": lambda: init_params(ssm),
        "init_params_hybrid": lambda: init_params(hybrid),
        "init_cache_ssm": lambda: init_cache(ssm, 2, 8),
        "init_cache_hybrid": lambda: init_cache(hybrid, 2, 8),
        "serve_cli_mamba2": lambda: serve.main(["--arch", "mamba2-130m",
                                                "--batch", "1"]),
        "params_from_numpy": lambda: params_from_numpy({}),
        "packed_from_numpy": lambda: packed_from_numpy({}),
        "serve_cli": lambda: serve.main(["--batch", "1"]),
        "serve_cli_memory": lambda: serve.main(["--batch", "1",
                                                "--packed-compute",
                                                "memory"]),
        "init_ultranet": lambda: init_ultranet(0),
        "ultranet_forward": lambda: ultranet_forward(
            cpu_params, torch.zeros(1, 16, 16, 3, dtype=torch.int32),
            mode="bseg"),
        "ultranet_params_from_numpy": lambda: ultranet_params_from_numpy(
            [], cpu_params.head.numpy()),
        "ultranet_cli": lambda: ultranet.main(["--size", "16"]),
        "engine": lambda: Engine(cfg, {}),
        "engine_speculative": lambda: Engine(cfg, {}, speculative=True),
        "calibrated_params": lambda: spec.calibrated_params(cfg, steps=1),
        "serve_cli_engine": lambda: serve.main(["--engine", "on",
                                                "--batch", "1"]),
        "loadgen_cli": lambda: loadgen.main(["--rates", "10",
                                             "--duration", "0.01"]),
        "loadgen_cli_speculative": lambda: loadgen.main(
            ["--speculative", "--train-steps", "1"]),
        "serve_cli_speculative": lambda: serve.main(
            ["--engine", "on", "--speculative", "--batch", "1"]),
        "autotune_layer": lambda: planner.autotune_layer(
            planner.matmul_spec("p", 1, 32, 16, w_bits=4, a_bits=8)),
        "opt_state_from_numpy": lambda: opt_state_from_numpy({}),
        "device_batch": lambda: SyntheticLMData(
            vocab=8, seq_len=4, global_batch=1).device_batch(0),
        "init_run": lambda: loop.init_run("tinyllama-1.1b", smoke=True),
        "run_qat": lambda: run_qat(QATRunConfig(steps=1)),
        "train_cli": lambda: train.main(["--smoke", "--steps", "1"]),
        "train_cli_qat": lambda: train.main(["--smoke", "--steps", "1",
                                             "--qat"]),
        "train_cli_mesh": lambda: train.main(["--smoke", "--steps", "1",
                                              "--mesh", "1,1"]),
    }


@pytest.mark.parametrize("name", ["init_params", "init_cache",
                                  "init_params_ssm", "init_params_hybrid",
                                  "init_cache_ssm", "init_cache_hybrid",
                                  "serve_cli_mamba2",
                                  "params_from_numpy",
                                  "packed_from_numpy", "serve_cli",
                                  "serve_cli_memory",
                                  "init_ultranet", "ultranet_forward",
                                  "ultranet_params_from_numpy",
                                  "ultranet_cli", "engine",
                                  "engine_speculative", "calibrated_params",
                                  "serve_cli_engine", "loadgen_cli",
                                  "loadgen_cli_speculative",
                                  "serve_cli_speculative",
                                  "autotune_layer", "opt_state_from_numpy",
                                  "device_batch", "init_run", "run_qat",
                                  "train_cli", "train_cli_qat",
                                  "train_cli_mesh"])
def test_entry_points_refuse_to_fall_back_to_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()
