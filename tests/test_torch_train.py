"""The torch port's training substrate against the JAX package's:
``data/pipeline.py`` (the same Philox integers), ``train/optimizer.py``
(one AdamW step, float32 and 8-bit moments, the schedule),
``train/checkpoint.py`` (each package restores the other's checkpoint;
corruption, the legacy format, GC, the async writer),
``train/straggler.py`` under a fake clock, ``train/loop.py``'s timing
seam and the training CLI (``python -m repro_torch.launch.train``).

Inputs come from seeded numpy generators and go to both packages.  The
optimizer runs in float32 on both; its tolerances are stated below.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLMData as JData
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro.train import straggler as jstr

from repro_torch import tree
from repro_torch.data import SyntheticLMData
from repro_torch.models import opt_state_from_numpy, params_from_numpy
from repro_torch.train import checkpoint, loop, optimizer, straggler

#: AdamW in float32: parameters (float32 or bf16), moments, 8-bit moment
#: scales, the grad norm and the schedule within ULPS ulps of the
#: reference's (8-bit moment codes equal) — the float32 powers of the
#: bias corrections and the global norm's summation order may move the
#: last bit (1 ulp observed)
ULPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small CPU tensors: more only contend
    with the test workers running beside this one (and are slower here
    even alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("seed,step,n_hosts,host",
                         [(0, 0, 1, 0), (9, 123, 1, 0), (3, 7, 2, 1),
                          (5, 10_000, 4, 2)])
def test_batches_equal_reference(seed, step, n_hosts, host):
    kw = dict(vocab=1000, seq_len=24, global_batch=8, seed=seed,
              n_hosts=n_hosts, host_id=host)
    want = JData(**kw).batch_at(step)
    port = SyntheticLMData(**kw)
    got = port.batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    dev = port.device_batch(step, device="cpu")
    assert torch.equal(dev["tokens"], torch.from_numpy(want["tokens"]))
    # restart determinism, and a different step draws other tokens
    assert np.array_equal(port.batch_at(step)["tokens"], got["tokens"])
    assert not np.array_equal(port.batch_at(step + 1)["tokens"],
                              got["tokens"])


def _ulps(a: np.ndarray, b) -> int:
    """Largest distance in units in the last place between the
    reference's array ``a`` and the port's ``b`` (float32 or bf16)."""
    if a.dtype.name == "bfloat16":
        ai, bi = a.view(np.int16), b.view(torch.int16).numpy()
    else:
        ai = a.astype(np.float32).view(np.int32)
        bi = np.asarray(b, np.float32).view(np.int32)
    return int(np.abs(ai.astype(np.int64) - bi.astype(np.int64)).max())


def _opt_case(grad_scale, seed):
    """A parameter tree with a bf16 matrix, a float32 matrix large
    enough for 8-bit moments and a float32 vector, and float32
    gradients scaled so the global norm is above (clip) or below (no
    clip) ``clip_norm``."""
    rng = _rng(seed)
    params = {"a": {"w": rng.standard_normal((64, 96))
                    .astype(jnp.bfloat16)},
              "b": rng.standard_normal(128).astype(np.float32),
              "c": rng.standard_normal((40, 128)).astype(np.float32)}
    grads = jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * grad_scale)
        .astype(np.float32), params)
    return params, grads


@pytest.mark.parametrize("moments_8bit", [False, True])
@pytest.mark.parametrize("grad_scale", [1e-3, 1.0])
def test_update_matches_reference(moments_8bit, grad_scale):
    """Two AdamW steps (the second from the first's moments) against the
    reference's: parameters within ``ULPS``, moments (float32, or the
    8-bit ``Q8`` codes and scales) equal, grad norm and lr equal."""
    params, grads = _opt_case(grad_scale, 0)
    kw = dict(lr=1e-3, warmup=3, total_steps=50, moments_8bit=moments_8bit)
    jcfg, tcfg = jopt.OptConfig(**kw), optimizer.OptConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    jst = jopt.init(jcfg, jp)
    tp = params_from_numpy(params, device="cpu")
    tg = params_from_numpy(grads, device="cpu")
    tst = optimizer.init(tcfg, tp)
    for _ in range(2):
        jp, jst, jm = jopt.update(jcfg, jg, jst, jp)
        tp, tst, tmet = optimizer.update(tcfg, tg, tst, tp)
    is_q8 = lambda x: isinstance(x, jopt.Q8)    # noqa: E731
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree.leaves(tp)):
        assert _ulps(np.asarray(a), b) <= ULPS
    for key in ("m", "v"):
        jl = jax.tree_util.tree_leaves(jst[key], is_leaf=is_q8)
        tl = tree.leaves(tst[key], optimizer.is_q8)
        assert len(jl) == len(tl) == 3
        for a, b in zip(jl, tl):
            assert is_q8(a) == optimizer.is_q8(b)
            if is_q8(a):
                np.testing.assert_array_equal(np.asarray(a.q), b.q.numpy())
                assert _ulps(np.asarray(a.scale), b.scale) <= ULPS
            else:
                assert _ulps(np.asarray(a), b) <= ULPS
    assert int(tst["step"]) == int(jst["step"]) == 2
    assert _ulps(np.asarray(jm["grad_norm"]), tmet["grad_norm"]) <= ULPS
    assert float(jm["lr"]) == float(tmet["lr"])


def test_8bit_moments_clip_before_cast():
    """``_q8`` saturates at +-127 (the clip precedes the int8 cast) and
    round-trips the reference's codes."""
    x = _rng(1).standard_normal((3, 4096)).astype(np.float32)
    x[0, 5] = 1e30                    # amax/scale rounds a hair past 127
    want = jopt._q8(jnp.asarray(x))
    got = optimizer._q8(torch.from_numpy(x))
    assert got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert int(got.q.abs().max()) == 127
    np.testing.assert_array_equal(optimizer._dq8(got).numpy(),
                                  np.asarray(jopt._dq8(want)))


def test_schedule_matches_reference():
    cfg = dict(lr=1e-3, lr_min=1e-4, warmup=10, total_steps=100)
    jcfg, tcfg = jopt.OptConfig(**cfg), optimizer.OptConfig(**cfg)
    for s in (0, 1, 5, 9, 10, 11, 37, 99, 100, 150):
        want = np.asarray(jopt.schedule(jcfg, jnp.asarray(s, jnp.int32)))
        got = optimizer.schedule(tcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert _ulps(want, got) <= ULPS, s
    assert abs(float(optimizer.schedule(tcfg, torch.tensor(10))) - 1e-3) \
        < 1e-6


def _ck_tree(seed):
    """A (params, opt) checkpoint tree of the shapes QAT saves: bf16 and
    float32 leaves, 8-bit moments, an int32 step."""
    rng = _rng(seed)
    params = {"blocks": {"w": rng.standard_normal((2, 64, 80))
                         .astype(jnp.bfloat16)},
              "ln": rng.standard_normal(64).astype(np.float32),
              "embed": rng.standard_normal((32, 64)).astype(jnp.bfloat16)}
    cfg = jopt.OptConfig(moments_8bit=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), jp)
    jp, jst, _ = jopt.update(cfg, grads, jopt.init(cfg, jp), jp)
    return jp, jst, jax.tree_util.tree_map(np.asarray, jp)


def _assert_same_leaves(jtree, ttree):
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jtree)]
    tl = tree.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        if a.dtype.name == "bfloat16":
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                b.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)


def test_port_restores_reference_checkpoint(tmp_path):
    jp, jst, host = _ck_tree(0)
    jck.save(str(tmp_path), 5, (jp, jst), extra={"who": "reference"})
    template = (params_from_numpy(host, device="cpu"),
                optimizer.init(optimizer.OptConfig(moments_8bit=True),
                               params_from_numpy(host, device="cpu")))
    assert checkpoint.latest_step(str(tmp_path)) == 5
    (tp, tst), meta = checkpoint.restore(str(tmp_path), 5, template)
    assert meta["extra"] == {"who": "reference"}
    _assert_same_leaves((jp, jst), (tp, tst))
    assert optimizer.is_q8(tst["m"]["blocks"]["w"])


def test_reference_restores_port_checkpoint(tmp_path):
    jp, jst, host = _ck_tree(1)
    tp = params_from_numpy(host, device="cpu")
    tst = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst),
                               device="cpu")
    _assert_same_leaves((jp, jst), (tp, tst))   # the state carried over
    path = checkpoint.save(str(tmp_path), 3, (tp, tst))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert "bfloat16" in meta["dtypes"] and meta["step"] == 3
    zeros = jax.tree_util.tree_map(jnp.zeros_like, (jp, jst))
    got, _ = jck.restore(str(tmp_path), 3, zeros)
    _assert_same_leaves(got, (tp, tst))


def test_checkpoint_roundtrip_gc_and_async(tmp_path):
    t = {"a": torch.arange(12.0).reshape(3, 4),
         "b": {"c": torch.ones(2, dtype=torch.int32)},
         "q": optimizer.Q8(torch.ones(3, dtype=torch.int8),
                           torch.full((1,), 0.5)),
         "step": torch.tensor(7, dtype=torch.int32)}
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(str(tmp_path / "sync"), s, t, keep=3)
    assert checkpoint.latest_step(str(tmp_path / "sync")) == 5
    assert len([d for d in os.listdir(tmp_path / "sync")
                if d.startswith("step_")]) == 3
    got, meta = checkpoint.restore(str(tmp_path / "sync"), 5, t)
    assert meta["step"] == 5 and isinstance(got["q"], optimizer.Q8)
    for a, b in zip(tree.leaves(t), tree.leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    ck = checkpoint.AsyncCheckpointer(str(tmp_path / "async"), keep=2)
    x = {"x": torch.arange(8.0)}
    ck.save_async(1, x)
    x["x"] = x["x"] + 1               # the snapshot was taken already
    ck.wait()
    got, _ = checkpoint.restore(str(tmp_path / "async"), 1, x)
    assert torch.equal(got["x"], torch.arange(8.0))


def test_checkpoint_corruption_detected(tmp_path):
    t = {"a": torch.arange(12.0).reshape(3, 4)}
    path = checkpoint.save(str(tmp_path), 3, t)
    _, meta = checkpoint.restore(str(tmp_path), 3, t)
    assert meta["checksum"] == checkpoint._sha256(
        os.path.join(path, "leaves.npz"))
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path), 99, t)
    leaves = os.path.join(path, "leaves.npz")
    data = open(leaves, "rb").read()
    with open(leaves, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(checkpoint.CheckpointCorrupt, match="checksum"):
        checkpoint.restore(str(tmp_path), 3, t)
    with open(os.path.join(path, "meta.json"), "w") as f:
        f.write('{"step": 3, "n_lea')
    with pytest.raises(checkpoint.CheckpointCorrupt, match="meta"):
        checkpoint.restore(str(tmp_path), 3, t)


def test_checkpoint_legacy_without_checksum(tmp_path):
    """A checkpoint without ``checksum`` in meta (the JAX package's old
    format) still restores; a garbled legacy payload is
    ``CheckpointCorrupt``."""
    t = {"a": torch.arange(6.0)}
    path = jck.save(str(tmp_path), 1, {"a": jnp.arange(6.0,
                                                       dtype=jnp.float32)})
    meta_path = os.path.join(path, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    del meta["checksum"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    got, _ = checkpoint.restore(str(tmp_path), 1, t)
    assert torch.equal(got["a"], torch.arange(6.0))
    with open(os.path.join(path, "leaves.npz"), "wb") as f:
        f.write(b"not a zip")
    with pytest.raises(checkpoint.CheckpointCorrupt, match="leaves"):
        checkpoint.restore(str(tmp_path), 1, t)


@pytest.mark.parametrize("durations", [
    [1.0] * 6 + [5.0, 5.0],                 # sustained straggle
    [1.0] * 6 + [5.0, 1.0, 5.0, 1.0],       # isolated blips
    [0.5, 3.0, 1.0, 1.2, 4.0, 4.0, 4.0, 1.0, 0.9],
])
def test_straggler_monitor_matches_reference(durations):
    def run(mod):
        t = [0.0]
        mon = mod.StepMonitor(mod.StragglerPolicy(patience=2,
                                                  warmup_steps=1),
                              clock=lambda: t[0])
        trace = []
        for d in durations:
            mon.start()
            t[0] += d
            mon.stop()
            trace.append((mon.should_mitigate, mon.stats()))
        return trace
    assert run(straggler) == run(jstr)


def test_run_training_sync_inside_timed_region():
    """``run_training`` calls ``sync`` INSIDE the monitor's timed
    region, so asynchronous launches cannot fake fast steps."""
    t = {"v": 0.0}

    def sync(_):
        t["v"] += 1.0          # device work "completes" during sync

    class Data:
        def batch_at(self, s):
            return {"tokens": np.zeros((1, 2), np.int32)}

    seen = []
    mon = straggler.StepMonitor(clock=lambda: t["v"])
    loop.run_training(None, None, {}, {}, Data(), steps=3, monitor=mon,
                      clock=lambda: t["v"], sync=sync,
                      step_fn=lambda p, o, b: (p, o, {"loss": 0.0}),
                      on_step=lambda s, p, o, m, dt, mo: seen.append(dt))
    assert seen == [1.0, 1.0, 1.0]


def test_train_cli_float_and_qat(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU: float training
    with a checkpoint and a resume, then ``--qat`` with ``--export`` and
    a QAT resume; ``--mesh 2,2`` refuses on a one-rank process group."""
    import signal

    from repro_torch.launch import train
    handler = signal.getsignal(signal.SIGTERM)
    try:
        _train_cli(train, tmp_path, capsys)
    finally:                         # the float run installs its own
        signal.signal(signal.SIGTERM, handler)


def _train_cli(train, tmp_path, capsys):
    ck = str(tmp_path / "ck")
    base = ["--smoke", "--device", "cpu", "--seq", "16",
            "--global-batch", "2", "--ckpt-dir", ck]
    train.main(base + ["--steps", "2"])
    assert checkpoint.latest_step(ck) == 2
    train.main(base + ["--steps", "3", "--resume"])
    assert checkpoint.latest_step(ck) == 3
    out = capsys.readouterr().out
    assert "resumed at step 2" in out
    qat = ["--smoke", "--device", "cpu", "--seq", "16", "--global-batch",
           "2", "--ckpt-dir", str(tmp_path / "qat"), "--qat"]
    train.main(qat + ["--steps", "2", "--export", str(tmp_path / "serve")])
    out = capsys.readouterr().out
    assert "qat: 8 packed layers" in out
    assert checkpoint.latest_step(str(tmp_path / "serve")) == 2
    train.main(qat + ["--steps", "3", "--resume"])
    assert "[qat] resumed at step 2" in capsys.readouterr().out
    assert checkpoint.latest_step(str(tmp_path / "qat")) == 3
    with pytest.raises(ValueError, match="2 x 2 ranks"):
        train.main(["--mesh", "2,2", "--device", "cpu"])


def test_train_cli_qat_smoke_exits_zero(tmp_path):
    """``python -m repro_torch.launch.train --qat --smoke --steps 2
    --device cpu`` as a user runs it (its checkpoint under $TMPDIR)."""
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src), TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--qat",
         "--smoke", "--steps", "2", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "qat: 8 packed layers" in proc.stdout
    assert checkpoint.latest_step(
        str(tmp_path / "repro_torch_launch_train")) == 2
