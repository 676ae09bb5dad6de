"""Parity of the torch port's moe family with the JAX package on reduced
llama4-maverick-400b-a17b (2 layers in one group of ``moe_every = 2``: a
MoE block with a shared expert, top-1 of 4 experts, then a dense block
``blocks_dense1``; d_model 128, vocab 512), with the helpers of
``tests/test_torch_moe.py``: the tree's structure, ``prefill_step`` + 6
``decode_step``s + one ``verify_step`` in SDV and memory modes against
the JAX package run op by op (logits within one bf16 rounding of their
scale, the int8 caches bit-identical), and ``forward`` on both reduced
MoE models.

Reference property (e) (ROADMAP Queue C): under ``moe_every > 1`` the
JAX package calls attention without the int8 cache's scales, so it
writes K/V truncated to int8 and leaves ``k_scale`` at zero.
``test_reference_property_e`` shows it on the reference alone; the
port's caches equal the reference's bit for bit, so it does the same.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import decode_step, init_cache, values

import repro_torch.models as tm
from test_torch_moe import (B, RULES, check_forward, check_runs, jax_run,
                            model_setup, port_run)


@pytest.fixture(scope="module")
def llama4():
    return model_setup("llama4-maverick")


def test_tree_structure_matches_reference(llama4):
    """The port's ``init_params`` has the reference's keys, shapes and
    dtypes: ``blocks`` (attention, router, banks, shared expert) and
    ``blocks_dense1`` stacked over the one group."""
    from repro_torch import tree
    s = llama4
    ref = jax.tree_util.tree_leaves_with_path(s["params"])
    port = tm.init_params(s["tcfg"], seed=0, device="meta")
    flat = tree.leaves(port)
    assert len(ref) == len(flat)
    for (path, a), b in zip(ref, flat):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path
    assert set(port) == {"embed", "ln_f", "lm_head", "blocks",
                         "blocks_dense1"}
    assert "shared" in port["blocks"]["moe"] and "mlp" in port[
        "blocks_dense1"]


@pytest.mark.parametrize("compute", ["sdv", "memory"])
def test_decode_and_verify_match_reference(llama4, compute):
    check_runs(jax_run(llama4, compute), port_run(llama4, compute), compute)


def test_forward_matches_reference(llama4):
    check_forward(llama4)


def test_forward_matches_reference_phi():
    check_forward(model_setup("phi3.5-moe", packed=False))


def test_reference_property_e(llama4):
    """One decode step of reduced llama4 in the reference: every
    ``k_scale``/``v_scale`` entry stays zero and the int8 K holds
    truncated values (|k| <= 8), where a scaled write would reach 127;
    the port's run (``check_runs``) holds its caches to these bits."""
    cfg = llama4["cfg"]
    cache = values(init_cache(cfg, RULES, B, 4))
    tok = jnp.asarray(llama4["tokens"][0], jnp.int32)
    _, cache = decode_step(cfg, llama4["jq", "sdv"], cache, tok)
    assert float(np.abs(np.asarray(cache["k_scale"])).sum()) == 0.0
    assert float(np.abs(np.asarray(cache["v_scale"])).sum()) == 0.0
    k = np.abs(np.asarray(cache["k"]).astype(np.int32))
    assert 0 < k.max() <= 8
