"""The port's linearize (K3's plain version and its CPU dispatch) against
the JAX package's Pallas kernel in interpret mode on cartpole, B=3, T=5:
1e-10 in f64, and against central finite differences of the port's own
step at 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import builders as jb
from nimblephysics_tpu.models.model import relax_limits as jrelax
from nimblephysics_tpu.ops.pallas_linearize import linearize_pallas

from nimblephysics_tpu_torch.ops.cuda_linearize import dyn_for_trace, linearize, linearize_plain
from nimblephysics_tpu_torch.utils.fd import fd_jacobian

from torch_port_helpers import t64, to_port

B, T = 3, 5


@pytest.fixture(scope="module")
def case():
    mj = jrelax(jb.cartpole(dt=0.02))
    rng = np.random.default_rng(3)
    xs = rng.uniform(-0.5, 0.5, (B, T, 4))
    xs[0, 0] = 0.0          # the pole exactly upright: Rodrigues' Taylor branch
    u = rng.standard_normal((B, T, 1))
    return mj, to_port(mj), xs, u


def test_linearize_matches_pallas(case):
    mj, mt, xs, u = case
    fx_j, fu_j = linearize_pallas(mj, jnp.asarray(xs), jnp.asarray(u), block_b=128)
    fx, fu = linearize(mt, t64(xs), t64(u))
    np.testing.assert_allclose(fx.numpy(), np.asarray(fx_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(fu.numpy(), np.asarray(fu_j), rtol=1e-10, atol=1e-10)


def test_linearize_matches_finite_differences(case):
    _, mt, xs, u = case
    fx, fu = linearize_plain(mt, t64(xs), t64(u))
    dyn = dyn_for_trace(mt)
    for b, t in ((0, 0), (2, 4)):
        z0 = np.concatenate([xs[b, t], u[b, t]])

        def f(z):
            x, uu = t64(z[:4]), t64(z[4:])
            return dyn(x, uu).numpy()

        J = fd_jacobian(f, z0, eps=1e-6)
        np.testing.assert_allclose(fx[b, t].numpy(), J[:, :4], atol=1e-6)
        np.testing.assert_allclose(fu[b, t].numpy(), J[:, 4:], atol=1e-6)


def test_linearize_f32_stays_f32(case):
    """f32 inputs give f32 Jacobians (torch.func would promote a 0-dim
    tensor times a Python float to f64)."""
    mj, mt, xs, u = case
    m32 = to_port(mj, dtype=torch.float32)
    fx, fu = linearize(m32, t64(xs).float(), t64(u).float())
    assert fx.dtype == fu.dtype == torch.float32
    fx64, _ = linearize(mt, t64(xs), t64(u))
    np.testing.assert_allclose(fx.numpy(), fx64.numpy(), atol=1e-5)
