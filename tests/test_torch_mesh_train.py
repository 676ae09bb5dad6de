"""Sharded training of the torch port (``launch/mesh.py``,
``models/shard_ctx.py``, ``launch/train.py --mesh``) on ``gloo`` meshes
on the CPU, against the JAX package.

Four ranks (``tests/torch_mesh_ranks.py``) train reduced tinyllama-1.1b
from the reference's weights (``init_params(cfg, rules, PRNGKey(0))``
carried by ``params_from_numpy``) on the reference distribution test's
batch (4 x 33 tokens from ``default_rng(0)``) and ``OptConfig(lr=1e-3,
warmup=1, total_steps=8)``, 4 steps, first on a (2, 2) ("data",
"model") mesh, then on (4, 1): parameters and moments are ``DTensor``
shards by ``param_specs``, the batch is sharded along "data", the step
runs under ``shard_ctx.use_rules``.  The losses must be within
``LOSS_TOL`` of the reference's single-device losses, run op by op
(the reference's own (4, 2) mesh run takes ~105 s here; its losses,
6.2363176 5.7866974 5.4682970 5.2295814, are within 4.4e-4 of its
single-device ones), and within ``MESH_TOL`` of the port's own
single-device losses: a mesh reduces the same bf16 products in another
order.  A checkpoint saved on (2, 2) restores onto (4, 1) bit for bit
(elastic resharding), with the (4, 1) placements; the launcher's
``--mesh 2,2`` runs through ``main(argv)`` on the same group and resumes
from its checkpoint; ``--mesh 1,1`` started plain makes its own one-rank
group.
"""
import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import ARCHS as JARCHS
from repro.models import Rules as JRules
from repro.models import init_params as j_init_params
from repro.models import values as j_values
from repro.train import loop as jloop
from repro.train import optimizer as joptimizer

from repro_torch.configs.registry import get_arch
from repro_torch.launch import train as launcher
from repro_torch.models import params_from_numpy
from repro_torch.train import checkpoint, loop, optimizer

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"
STEPS = 4
MESHES = [(2, 2), (4, 1)]
#: port mesh losses vs the reference's single-device op-by-op losses
LOSS_TOL = 2e-3
#: port mesh losses vs the port's single-device losses
MESH_TOL = 2e-3


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    cfg = JARCHS[ARCH].reduced()
    params = j_values(j_init_params(cfg, JRules(), jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (4, 33)) \
        .astype(np.int32)
    host = jax.tree_util.tree_map(np.asarray, params)
    torch.save({"params": params_from_numpy(host, device="cpu"),
                "tokens": torch.from_numpy(tokens), "meshes": MESHES,
                "steps": STEPS, "ck_dir": str(tmp / "elastic"),
                "launch_dir": str(tmp / "launch"), "launch_mesh": "2,2"},
               tmp / "in.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    port = subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                 "torch_mesh_ranks.py"),
                             "mesh_train", "4", str(tmp / "in.pt"),
                             str(tmp)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    # meanwhile: the launcher's one-rank mesh started plain (its own
    # group), and the reference op by op on one device
    one_rank = io.StringIO()
    with contextlib.redirect_stdout(one_rank):
        launcher.main(["--smoke", "--mesh", "1,1", "--device", "cpu",
                       "--steps", "1", "--global-batch", "2", "--seq", "8",
                       "--microbatches", "1", "--ckpt-dir",
                       str(tmp / "one_rank")])
    one_rank_group_left = dist.is_initialized()
    ocfg = joptimizer.OptConfig(lr=1e-3, warmup=1, total_steps=8)
    step = jloop.make_train_step(cfg, ocfg)
    pv, opt, ref = params, joptimizer.init(ocfg, params), []
    batch = {"tokens": jnp.asarray(tokens)}
    for _ in range(STEPS):
        pv, opt, m = step(pv, opt, batch)
        ref.append(float(m["loss"]))
    out, err = port.communicate(timeout=600)
    assert port.returncode == 0, err[-4000:]
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return {"ref": ref, "ranks": ranks, "stdout": out, "tokens": tokens,
            "host": host, "one_rank": (one_rank.getvalue(),
                                       one_rank_group_left,
                                       tmp / "one_rank")}


def _port_single(host, tokens):
    cfg = get_arch(ARCH).reduced()
    ocfg = optimizer.OptConfig(lr=1e-3, warmup=1, total_steps=8)
    params = params_from_numpy(host, device="cpu")
    opt, step, losses = optimizer.init(ocfg, params), \
        loop.make_train_step(cfg, ocfg), []
    for _ in range(STEPS):
        params, opt, m = step(params, opt,
                              {"tokens": torch.from_numpy(tokens)})
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_losses_match_reference(mesh_run, shape):
    key = f"losses_{shape[0]}x{shape[1]}"
    losses = mesh_run["ranks"][0][key]
    assert all(r[key] == losses for r in mesh_run["ranks"])
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, mesh_run["ref"], rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(
        losses, _port_single(mesh_run["host"], mesh_run["tokens"]),
        rtol=0, atol=MESH_TOL)


def test_elastic_checkpoint_reshards_bit_for_bit(mesh_run):
    for r in mesh_run["ranks"]:
        assert r["elastic_exact"]
    got, saved = mesh_run["ranks"][0]["elastic_local_shapes"]
    assert len(got) == len(saved) == 12
    # embed [512, 128] and lm_head [128, 512] are sharded on "model": a
    # rank holds half on (2, 2), the whole on (4, 1)
    assert {(256, 128), (128, 256)} <= set(saved)
    assert {(512, 128), (128, 512)} <= set(got)


def test_launcher_mesh_runs_and_resumes(mesh_run):
    assert all(r["launch_steps"] == 3 for r in mesh_run["ranks"])
    assert "resumed at step 2" in mesh_run["stdout"]
    assert "mesh {'data': 2, 'model': 2}" in mesh_run["stdout"]


def test_launcher_one_rank_mesh_makes_its_own_group(mesh_run):
    out, group_left, ck_dir = mesh_run["one_rank"]
    assert not group_left
    assert checkpoint.latest_step(str(ck_dir)) == 1
    assert "step    1 loss" in out


def test_mesh_needs_every_rank(tmp_path):
    with pytest.raises(ValueError, match="2 x 2 ranks"):
        launcher.main(["--smoke", "--mesh", "2,2", "--device", "cpu",
                       "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not dist.is_initialized()
