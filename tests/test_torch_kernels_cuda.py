"""The port's CUDA kernels (B1 GEMV, B2 GEMM) against their plain torch
version and the exact integer product.

Imports only the port, so it runs on a machine with a card and no JAX:

  PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Without a card every test skips: a CUDA kernel has no CPU mode.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.datapath import DATAPATHS, plan_sdv
from repro_torch.kernels import ops, sdv_matmul, sdv_matvec


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _case(spec, wa, wb, signed_a, m, k, rows, seed):
    plan = plan_sdv(DATAPATHS[spec], wa, wb, signed_a=signed_a,
                    signed_b=True, park_sign_bits=signed_a)
    rng = np.random.default_rng(seed)
    lo, hi = (-(1 << wa - 1), 1 << wa - 1) if signed_a else (0, 1 << wa)
    w = rng.integers(lo, hi, (m, k))
    x = rng.integers(-(1 << wb - 1), 1 << wb - 1, (rows, k))
    words = ops.prepare_sdv_weights(torch.tensor(w), plan)
    return plan, w, x, words


@pytest.mark.parametrize("spec,wa,wb", [("int32", 4, 8), ("dsp48e2", 4, 8),
                                        ("dsp58", 4, 4), ("int32", 2, 2)])
@pytest.mark.parametrize("rows", [1, 3, 8, 9, 64, 77])
def test_kernels_match_plain_and_exact(cuda, spec, wa, wb, rows):
    plan, w, x, words = _case(spec, wa, wb, True, 301, 700, rows, rows)
    xt = torch.tensor(x, dtype=torch.int32)
    want = sdv_matmul.sdv_matmul_plain(xt, words, plan)
    assert (want.reshape(rows, -1)[:, :301].numpy() == x @ w.T).all()
    got = sdv_matmul.sdv_matmul(xt.to(cuda), words.to(cuda), plan=plan)
    torch.cuda.synchronize()
    assert (got.cpu() == want).all()
    if rows <= 8:
        got = sdv_matvec.sdv_matvec(xt.T.contiguous().to(cuda),
                                    words.to(cuda), plan=plan)
        torch.cuda.synchronize()
        assert (got.cpu() == want).all()


def test_unsigned_elements_on_gemm(cuda):
    plan, w, x, words = _case("dsp48e2", 3, 5, False, 40, 333, 20, 0)
    got = sdv_matmul.sdv_matmul(torch.tensor(x, dtype=torch.int32).to(cuda),
                                words.to(cuda), plan=plan)
    torch.cuda.synchronize()
    assert (got.cpu().reshape(20, -1)[:, :40].numpy() == x @ w.T).all()


def test_launch_counters_and_dispatch(cuda):
    plan, w, x, words = _case("int32", 4, 8, True, 64, 128, 12, 1)
    xd, wd = torch.tensor(x).to(cuda), words.to(cuda)
    b1, b2 = sdv_matvec.sdv_matvec.launches, sdv_matmul.sdv_matmul.launches
    plain = sdv_matmul.sdv_matmul_plain.calls
    y8 = ops.packed_matmul(xd[:8], wd, plan=plan, m=64)
    y12 = ops.packed_matmul(xd, wd, plan=plan, m=64)
    torch.cuda.synchronize()
    assert sdv_matvec.sdv_matvec.launches == b1 + 1
    assert sdv_matmul.sdv_matmul.launches == b2 + 1
    assert sdv_matmul.sdv_matmul_plain.calls == plain
    assert (y12.cpu().numpy() == x @ w.T).all()
    assert (y8.cpu().numpy() == x[:8] @ w.T).all()
