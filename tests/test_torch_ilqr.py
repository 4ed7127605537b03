"""The slice end to end: the port's ilqr_solve_batch against the JAX
package's ilqr_solve_batch (its Pallas kernels in interpret mode) on
bench.py's cartpole task, B=4, T=10, 3 iterations, f64: u, cost and
cost_history to 1e-9. Also the port's own ilqr_solve against its batch
solver, the entry points' refusal without CUDA, and the package's import
boundary."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import builders as jb
from nimblephysics_tpu.models.model import relax_limits as jrelax
from nimblephysics_tpu.trajectory.ilqr import ILQRConfig as JConfig
from nimblephysics_tpu.trajectory.ilqr import ilqr_solve_batch as j_solve_batch

from nimblephysics_tpu_torch.models import builders
from nimblephysics_tpu_torch.models.convert import model_from_numpy
from nimblephysics_tpu_torch.models.model import State, build_model
from nimblephysics_tpu_torch.trajectory.ilqr import ILQRConfig, ilqr_solve, ilqr_solve_batch

from torch_port_helpers import (jax_cartpole_costs, jax_leaves, jax_static,
                                port_cartpole_costs, t64, to_port)

B, T, ITERS = 4, 10, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def case():
    mj = jrelax(jb.cartpole(dt=0.02))
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.3, 0.3, (B, 2 * mj.nq))
    u0 = np.zeros((B, T, mj.num_actions))
    run_j, fin_j = jax_cartpole_costs(mj.nq)
    sol_j = j_solve_batch(mj, jnp.asarray(x0), jnp.asarray(u0), run_j, fin_j,
                          JConfig(iters=ITERS), block_b=8)
    mt = to_port(mj)
    run_t, fin_t = port_cartpole_costs(mt)
    sol_t = ilqr_solve_batch(mt, t64(x0), t64(u0), run_t, fin_t, ILQRConfig(iters=ITERS))
    return dict(mt=mt, x0=x0, u0=u0, sol_j=sol_j, sol_t=sol_t, costs=(run_t, fin_t))


@pytest.mark.parametrize("field", ["u", "x", "cost", "cost_history", "K", "k"])
def test_ilqr_solve_batch_matches_jax(case, field):
    a = getattr(case["sol_t"], field).numpy()
    b = np.asarray(getattr(case["sol_j"], field))
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)


def test_ilqr_solve_batch_improves_every_world(case):
    sol = case["sol_t"]
    hist = sol.cost_history.numpy()
    assert np.isfinite(hist).all()
    assert (np.diff(hist, axis=0) <= 0).all()
    assert (hist[-1] < hist[0]).all()


def test_ilqr_solve_matches_batch(case):
    """The per-world sequential reference takes the same iterations."""
    run_t, fin_t = case["costs"]
    sol_b = case["sol_t"]
    for b in (0, B - 1):
        sol = ilqr_solve(case["mt"], State.from_flat(t64(case["x0"][b])), t64(case["u0"][b]),
                         run_t, fin_t, ILQRConfig(iters=ITERS))
        np.testing.assert_allclose(sol.u.numpy(), sol_b.u[b].numpy(), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(sol.cost_history.numpy(), sol_b.cost_history[:, b].numpy(),
                                   rtol=1e-9, atol=1e-9)


def test_plain_config_matches_kernel_config_on_cpu(case):
    run_t, fin_t = case["costs"]
    sol = ilqr_solve_batch(case["mt"], t64(case["x0"]), t64(case["u0"]), run_t, fin_t,
                           ILQRConfig(iters=ITERS, kernels=False))
    assert torch.equal(sol.u, case["sol_t"].u)


def test_unported_options_raise(case):
    run_t, fin_t = case["costs"]
    args = (case["mt"], t64(case["x0"]), t64(case["u0"]), run_t, fin_t)
    with pytest.raises(NotImplementedError, match="M5"):
        ilqr_solve_batch(*args, classes=object())
    with pytest.raises(NotImplementedError, match="parallel"):
        ilqr_solve_batch(*args, ILQRConfig(riccati="parallel"))
    limited = builders.cartpole(device="cpu", dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="M4"):
        ilqr_solve_batch(limited, *args[1:])


def test_entry_points_raise_without_cuda(monkeypatch):
    """device defaults to "cuda": without it the entry points raise rather
    than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mj = jb.cartpole()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        builders.cartpole()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        builders.pendulum()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model([dict(type="revolute")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model_from_numpy(jax_static(mj), jax_leaves(mj))
    assert builders.cartpole(device="cpu").device.type == "cpu"


def test_import_pulls_in_no_jax():
    code = ("import sys, nimblephysics_tpu_torch\n"
            "import nimblephysics_tpu_torch.trajectory.ilqr\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'nimblephysics_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=REPO,
                   timeout=120)
