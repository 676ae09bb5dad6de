"""The port's int8 SDV-packed gradient all-reduce
(``repro_torch.train.grad_compress``) against the JAX package's, bit for
bit, on the CPU.

* ``pack_grad_words`` / ``unpack_grad_words`` equal the reference's words
  and lane sums at an odd size (1001) and at the lane-sum bound
  (+-127 x ``MAX_PACKED_DEVICES``);
* one rank (a one-rank ``gloo`` group and ``DeviceMesh``) against the
  reference's one-device mesh: g_hat and the error, packed and unpacked;
* four ``gloo`` ranks (``tests/torch_mesh_ranks.py``) against the
  reference's four-device mesh with ``Auto`` axes, run in a subprocess
  with ``--xla_force_host_platform_device_count=4`` (``jax.make_mesh``
  builds ``Explicit`` axes under this jax, which ``shard_map`` refuses):
  g_hat and each rank's error after one call, packed and unpacked, and
  the running sum of the first 3 error-fed steps, bit for bit (the
  reference's eager ``shard_map`` takes ~2.6 s a call here; under
  ``jax.jit`` XLA fuses the error's multiply-subtract and moves its last
  bit); the port's sum over 30 steps within 0.02 of the true mean's
  (relative), as the reference's own test asks;
* the guard: packing past ``MAX_PACKED_DEVICES`` ranks raises before any
  collective.
"""
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

from repro.train import grad_compress as jgc

from repro_torch.train import grad_compress as tgc

ROOT = Path(__file__).resolve().parents[1]
STEPS = 30
REF_STEPS = 3

_REF_4 = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
from repro.train.grad_compress import compressed_allreduce
mesh = Mesh(np.array(jax.devices()).reshape(4), ("data",))
g_local = np.load(sys.argv[1])["g_local"]
sh = NamedSharding(mesh, PS("data"))
grads = {"w": jax.device_put(jnp.asarray(g_local), sh)}
zero = {"w": jax.device_put(jnp.zeros_like(grads["w"]), sh)}
out = {}
for tag, pack in (("p", True), ("u", False)):
    gh, e = compressed_allreduce(grads, zero, mesh, pack_words=pack)
    out["gh_" + tag] = np.asarray(gh["w"])
    out["e_" + tag] = np.asarray(e["w"])
acc = np.zeros(g_local.shape[1:], np.float32)
errs = zero
for _ in range(int(sys.argv[3])):
    gh, errs = compressed_allreduce(grads, errs, mesh)
    acc += np.asarray(gh["w"])
out["acc"] = acc
np.savez(sys.argv[2], **out)
"""


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("size", [1001, 64])
def test_grad_words_match_reference(size):
    rng = np.random.default_rng(size)
    q = rng.integers(-127, 128, size).astype(np.int8)
    words = tgc.pack_grad_words(torch.from_numpy(q))
    ref = jgc.pack_grad_words(jnp.asarray(q))
    assert words.dtype == torch.int32 and words.shape == (-(-size // 2),)
    assert np.array_equal(words.numpy(), np.asarray(ref))
    summed = words * 3
    assert np.array_equal(tgc.unpack_grad_words(summed, size).numpy(),
                          np.asarray(jgc.unpack_grad_words(
                              jnp.asarray(summed.numpy()), size)))
    assert np.array_equal(tgc.unpack_grad_words(summed, size).numpy(),
                          q.astype(np.int32) * 3)


@pytest.mark.parametrize("v", [127, -127])
def test_grad_words_survive_device_bound(v):
    nd = tgc.MAX_PACKED_DEVICES
    q = torch.full((64,), v, dtype=torch.int8)
    w = tgc.pack_grad_words(q) * nd
    assert np.array_equal(w.numpy(), np.asarray(
        jgc.pack_grad_words(jnp.full((64,), v, jnp.int8)) * nd))
    assert np.array_equal(tgc.unpack_grad_words(w, 64).numpy(),
                          np.full(64, v * nd))


@pytest.fixture
def one_rank_mesh(tmp_path):
    from torch.distributed.device_mesh import init_device_mesh
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_one_rank_matches_reference(one_rank_mesh):
    from jax.sharding import Mesh
    rng = np.random.default_rng(3)
    g = rng.standard_normal((1, 4097)).astype(np.float32)
    e = (rng.standard_normal((1, 4097)) * 1e-3).astype(np.float32)
    jmesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    for pack in (True, False):
        jg, je = jgc.compressed_allreduce({"w": jnp.asarray(g)},
                                          {"w": jnp.asarray(e)}, jmesh,
                                          pack_words=pack)
        tg, te = tgc.compressed_allreduce({"w": torch.from_numpy(g[0])},
                                          {"w": torch.from_numpy(e[0])},
                                          one_rank_mesh, pack_words=pack)
        assert np.array_equal(_bits(tg["w"].numpy()), _bits(jg["w"]))
        assert np.array_equal(_bits(te["w"].numpy()), _bits(je["w"][0]))


def test_guard_refuses_before_any_collective():
    class FakeMesh:
        shape = {"data": tgc.MAX_PACKED_DEVICES + 1}

    with pytest.raises(ValueError, match="overflow"):
        tgc.compressed_allreduce({}, {}, FakeMesh(), pack_words=True)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The port's 4 ranks and the reference's 4 devices on the same
    per-rank gradients (``default_rng(0)``, scaled by 1e-3)."""
    tmp = tmp_path_factory.mktemp("gc4")
    g_local = (np.random.default_rng(0).standard_normal((4, 1024))
               .astype(np.float32) * 1e-3)
    np.savez(tmp / "in.npz", g_local=g_local)
    torch.save({"g_local": g_local, "steps": STEPS,
                "ref_steps": REF_STEPS}, tmp / "in.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", _REF_4,
                            str(tmp / "in.npz"), str(tmp / "ref.npz"),
                            str(REF_STEPS)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    port = subprocess.run([sys.executable, str(ROOT / "tests" /
                                               "torch_mesh_ranks.py"),
                           "grad_compress", "4", str(tmp / "in.pt"),
                           str(tmp)], env=env, capture_output=True,
                          text=True, timeout=300)
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-4000:]
    assert port.returncode == 0, port.stderr[-4000:]
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return g_local, dict(np.load(tmp / "ref.npz")), ranks


@pytest.mark.parametrize("tag", ["p", "u"])
def test_four_ranks_match_reference(four_ranks, tag):
    _, ref, ranks = four_ranks
    for r, out in enumerate(ranks):
        assert np.array_equal(_bits(out[f"gh_{tag}"].numpy()),
                              _bits(ref[f"gh_{tag}"]))
        assert np.array_equal(_bits(out[f"e_{tag}"].numpy()),
                              _bits(ref[f"e_{tag}"][r]))


def test_four_ranks_packed_equals_unpacked(four_ranks):
    for out in four_ranks[2]:
        assert torch.equal(out["gh_p"], out["gh_u"])
        assert np.array_equal(_bits(out["e_p"].numpy()),
                              _bits(out["e_u"].numpy()))


def test_four_ranks_error_feedback(four_ranks):
    g_local, ref, ranks = four_ranks
    true = g_local.mean(axis=0) * STEPS
    for out in ranks:
        assert np.array_equal(_bits(out["acc_ref_steps"]), _bits(ref["acc"]))
        assert np.abs(out["acc"] - true).max() / np.abs(true).max() < 0.02
