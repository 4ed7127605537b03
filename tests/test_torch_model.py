"""The port's model, dynamics and step against the JAX package (CPU, f64).

Builders' leaves must be equal exactly; aba, mass_matrix and rnea agree to
1e-12 and a 50-step rollout to 1e-10 on pendulum, the inverted double
pendulum and cartpole (its planning form, relax_limits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import builders as jb
from nimblephysics_tpu.models.model import State as JState, relax_limits as jrelax
from nimblephysics_tpu.ops import dynamics as jd
from nimblephysics_tpu.simulation.step import rollout as jrollout

from nimblephysics_tpu_torch.models import builders as tb
from nimblephysics_tpu_torch.models.model import LEAF_NAMES, State, relax_limits
from nimblephysics_tpu_torch.ops import dynamics as td
from nimblephysics_tpu_torch.simulation.step import rollout

from torch_port_helpers import jax_leaves, t64, to_port

MODELS = ["pendulum", "inverted_double_pendulum", "cartpole"]


def _pair(name):
    mj = getattr(jb, name)()
    mt = getattr(tb, name)(device="cpu", dtype=torch.float64)
    if name == "cartpole":   # the planning model: no limit rows
        mj, mt = jrelax(mj), relax_limits(mt)
    return mj, mt


@pytest.mark.parametrize("name", MODELS)
def test_builder_leaves_equal_jax(name):
    mj, mt = _pair(name)
    lj = jax_leaves(mj)
    lt = {k: v.numpy() for k, v in mt.leaves().items()}
    for k in LEAF_NAMES:
        assert lt[k].dtype == lj[k].dtype, k
        np.testing.assert_array_equal(lt[k], lj[k], err_msg=k)
    assert mt.joint_types == mj.joint_types and mt.parents == mj.parents
    assert mt.actuated == mj.actuated and mt.dof_names == mj.dof_names


@pytest.mark.parametrize("name", MODELS)
def test_model_from_numpy_carries_jax_leaves(name):
    mj, _ = _pair(name)
    mc = to_port(mj)
    for k, v in mc.leaves().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jax_leaves(mj)[k]), err_msg=k)
    assert (mc.nq, mc.num_actions, mc.dof_offsets) == (mj.nq, mj.num_actions, mj.dof_offsets)


@pytest.mark.parametrize("name", MODELS)
def test_dynamics_match_jax(name):
    """aba, mass_matrix and rnea to 1e-12 (f64), batched over 4 states."""
    mj, mt = _pair(name)
    rng = np.random.default_rng(0)
    q, v, tau = (rng.standard_normal((4, mj.nq)) for _ in range(3))
    aba_j, M_j, rnea_j = jax.jit(jax.vmap(lambda q, v, t: (
        jd.aba(mj, q, v, t), jd.mass_matrix(mj, q), jd.rnea(mj, q, v, t))))(q, v, tau)
    np.testing.assert_allclose(td.aba(mt, t64(q), t64(v), t64(tau)).numpy(),
                               np.asarray(aba_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(td.mass_matrix(mt, t64(q)).numpy(),
                               np.asarray(M_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(td.rnea(mt, t64(q), t64(v), t64(tau)).numpy(),
                               np.asarray(rnea_j), rtol=1e-12, atol=1e-12)
    # rnea inverts aba
    qdd = td.aba(mt, t64(q), t64(v), t64(tau))
    tau_back = td.rnea(mt, t64(q), t64(v), qdd)
    spring_damp = -mt.damping * t64(v)
    np.testing.assert_allclose((tau_back - spring_damp).numpy(), tau, atol=1e-10)


@pytest.mark.parametrize("name", MODELS)
def test_rollout_50_steps_matches_jax(name):
    """A 50-step rollout of random actions agrees to 1e-10 (f64)."""
    mj, mt = _pair(name)
    rng = np.random.default_rng(1)
    q0 = 0.3 * rng.standard_normal(mj.nq)
    v0 = 0.3 * rng.standard_normal(mj.nq)
    acts = rng.standard_normal((50, mj.num_actions))
    fin_j, traj_j = jax.jit(lambda s, a: jrollout(mj, s, a))(
        JState(q=jnp.asarray(q0), v=jnp.asarray(v0)), jnp.asarray(acts))
    fin_t, traj_t = rollout(mt, State(q=t64(q0), v=t64(v0)), t64(acts))
    np.testing.assert_allclose(traj_t.q.numpy(), np.asarray(traj_j.q), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(traj_t.v.numpy(), np.asarray(traj_j.v), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(fin_t.flat().numpy(), np.asarray(fin_j.flat()),
                               rtol=1e-10, atol=1e-10)
