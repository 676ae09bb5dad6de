"""Packed QAT of the torch port's ssm and hybrid families against the JAX
package, on reduced mamba2-130m and recurrentgemma-2b.

``qat_params`` wraps the reference's leaf paths with its bitwidths and
plans (the short convs left float, as ``_SKIP_CONTAINERS`` has them);
then two QAT steps (W4A8, the planner's plans) from the reference's init
in both packages, the reference run op by op (layer loop unrolled, one
microbatch, no enclosing jit: ROADMAP Queue C, property (a)), each loss
within ``LOSS_ATOL``.  The compiled reference is not the yardstick: its
step-1 loss on reduced mamba2 is 0.0082 from its own op-by-op one (bf16
roundings moved by XLA reach the A8 quantizers), while the port's is
within 1e-6 of the op-by-op one.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch
from repro.data import SyntheticLMData as JData
from repro.models import Rules, init_params, values
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train.qat import ste as jste

import repro_torch.models as tm
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.data import SyntheticLMData
from repro_torch.train import loop, optimizer
from repro_torch.train.qat import ste
from test_torch_encdec import LOSS_ATOL
from test_torch_qat import _port_plan, _qat_paths

RULES = Rules(tp=None, fsdp=None, ep=None, batch=())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_two_qat_steps_match_reference(arch):
    """Packed QAT (W4A8, the planner's plans) from the reference's init:
    the same wrapped leaves, then two steps in both packages."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), scan_layers=False)
    tcfg = t_get_arch(arch).reduced()
    params = values(init_params(cfg, RULES, jax.random.PRNGKey(0)))
    tparams = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu")
    kw = dict(w_bits=4, a_bits=8, min_size=1 << 10, plan_policy="auto")
    qp = jste.qat_params(params, use_kernel=False, **kw)
    tqp = ste.qat_params(tparams, **kw)
    want = dict(_qat_paths(qp, is_qat=jste.is_qat))
    got = dict(_qat_paths(tqp, is_qat=ste.is_qat))
    assert sorted(got) == sorted(want)
    assert not any("conv" in p for p in got)
    assert len(got) == {"ssm": 5, "hybrid": 8 + 8 + 7 + 8}[cfg.family]
    for p, c in got.items():
        assert (c.w_bits, c.a_bits) == (want[p].w_bits, want[p].a_bits)
        assert c.plan == _port_plan(want[p].plan), p
    ocfg = dict(lr=1e-3, warmup=2, total_steps=2)
    jocfg, tocfg = jopt.OptConfig(**ocfg), optimizer.OptConfig(**ocfg)
    data = dict(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=0)
    jl, tl = [], []
    jloop.run_training(
        cfg, jocfg, qp, jopt.init(jocfg, qp), JData(**data), steps=2,
        step_fn=jloop.make_train_step(cfg, jocfg),
        on_step=lambda s, p, o, m, dt, mon: jl.append(float(m["loss"])))
    loop.run_training(
        tcfg, tocfg, tqp, optimizer.init(tocfg, tqp),
        SyntheticLMData(**data), steps=2,
        on_step=lambda s, p, o, m, dt, mon: tl.append(float(m["loss"])))
    assert len(tl) == len(jl) == 2 and np.all(np.isfinite(tl))
    assert np.abs(np.array(tl) - np.array(jl)).max() <= LOSS_ATOL


@pytest.mark.parametrize("arch,layers", [("mamba2-130m", 5),
                                         ("recurrentgemma-2b", 31)])
def test_train_cli_on_cpu(arch, layers, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch ... --smoke --device
    cpu``, float and ``--qat`` with ``--export``."""
    import signal

    from repro_torch.launch import train
    from repro_torch.train import checkpoint
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--seq", "16",
            "--global-batch", "2", "--steps", "2"]
    handler = signal.getsignal(signal.SIGTERM)
    try:                             # the float run installs its own
        train.main(base + ["--ckpt-dir", str(tmp_path / "ck")])
    finally:
        signal.signal(signal.SIGTERM, handler)
    assert checkpoint.latest_step(str(tmp_path / "ck")) == 2
    train.main(base + ["--qat", "--ckpt-dir", str(tmp_path / "qat"),
                       "--export", str(tmp_path / "serve")])
    out = capsys.readouterr().out
    assert f"qat: {layers} packed layers" in out
    assert "exported serving params" in out
    assert checkpoint.latest_step(str(tmp_path / "serve")) == 2
