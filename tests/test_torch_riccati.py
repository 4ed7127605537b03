"""The port's Riccati backward (K1's plain version and its CPU dispatch)
against the JAX package's Pallas kernel in interpret mode, f64, to 1e-10.

Inputs are built as tests/test_pallas.py builds them for the JAX kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.ops import linalg_small as jlinalg
from nimblephysics_tpu.ops.pallas_riccati import riccati_backward_pallas

from nimblephysics_tpu_torch.ops import linalg_small
from nimblephysics_tpu_torch.ops.cuda_riccati import riccati_backward, riccati_backward_plain

from torch_port_helpers import t64


def _inputs(nx, na, T, B, seed=1):
    rng = np.random.default_rng(seed)
    fx = 0.1 * rng.standard_normal((B, T, nx, nx)) + np.eye(nx)
    fu = 0.3 * rng.standard_normal((B, T, nx, na))
    lx = rng.standard_normal((B, T, nx))
    lu = rng.standard_normal((B, T, na))
    G = rng.standard_normal((B, T, nx, nx))
    lxx = np.einsum("btij,btkj->btik", G, G) / nx + 0.1 * np.eye(nx)
    Ga = rng.standard_normal((B, T, na, na))
    luu = np.einsum("btij,btkj->btik", Ga, Ga) / na + 0.5 * np.eye(na)
    lux = 0.1 * rng.standard_normal((B, T, na, nx))
    VxT = rng.standard_normal((B, nx))
    Gx = rng.standard_normal((B, nx, nx))
    VxxT = np.einsum("bij,bkj->bik", Gx, Gx) / nx + 0.1 * np.eye(nx)
    reg = np.abs(rng.standard_normal(B)) * 0.1 + 1e-3
    return (fx, fu, lx, lu, lxx, luu, lux, VxT, VxxT, reg)


@pytest.mark.parametrize("nx,na,T,B", [(4, 1, 9, 5), (6, 3, 4, 2)])
def test_riccati_matches_pallas(nx, na, T, B):
    args = _inputs(nx, na, T, B)
    K_j, k_j, dV_j, ok_j = riccati_backward_pallas(*map(jnp.asarray, args), block_b=8)
    # the wrapper on CPU tensors runs the plain version
    K, k, dV, ok = riccati_backward(*map(t64, args))
    for a, b in ((K, K_j), (k, k_j), (dV, dV_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-10)
    assert (ok.numpy() == np.asarray(ok_j)).all()
    K2, k2, dV2, ok2 = riccati_backward_plain(*map(t64, args))
    assert torch.equal(K, K2) and torch.equal(k, k2) and torch.equal(ok, ok2)


def test_riccati_flags_indefinite_quu():
    """A strongly negative luu makes Quu_reg indefinite: ok is False for
    that world only, as the minimum pivot of the elimination says."""
    args = list(_inputs(4, 1, 6, 3, seed=2))
    args[5] = args[5].copy()
    args[5][1, 3] = -50.0
    K, k, dV, ok = riccati_backward_plain(*map(t64, args))
    assert ok.tolist() == [True, False, True]
    assert torch.isfinite(K[0]).all() and torch.isfinite(K[2]).all()


@pytest.mark.parametrize("n", [1, 2, 3, 6])
def test_inv_spd_pivots_matches_jax(n):
    rng = np.random.default_rng(n)
    G = rng.standard_normal((5, n, n))
    A = np.einsum("bij,bkj->bik", G, G) + 0.1 * np.eye(n)
    inv_j, piv_j = jax.vmap(jlinalg.inv_spd_pivots)(jnp.asarray(A))
    inv_t, piv_t = linalg_small.inv_spd_pivots(t64(A))
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(piv_t.numpy(), np.asarray(piv_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(inv_t.numpy() @ A, np.broadcast_to(np.eye(n), A.shape),
                               atol=1e-9)


def test_riccati_wrapper_refuses_bad_inputs():
    args = list(map(t64, _inputs(4, 1, 3, 2)))
    bad = list(args)
    bad[0] = bad[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        riccati_backward(*bad)
    bad = list(args)
    bad[2] = bad[2][:, :2]
    with pytest.raises(ValueError, match="shape"):
        riccati_backward(*bad)
    bad = list(args)
    bad[9] = bad[9].float()
    with pytest.raises(ValueError, match="float32"):
        riccati_backward(*bad)
