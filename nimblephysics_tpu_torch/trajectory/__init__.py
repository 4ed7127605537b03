"""Trajectory optimization: the batched iLQR replan and shooting.

PyTorch counterpart of ``nimblephysics_tpu/trajectory`` (the reference's
``dart/trajectory/``): ``ilqr.py`` the main path's iLQR, ``shooting.py``
single and multiple shooting by fixed first-order iterations."""

from nimblephysics_tpu_torch.trajectory.shooting import (  # noqa: F401
    MultipleShootingProblem,
    SingleShootingProblem,
    solve_multiple_shooting,
    solve_single_shooting,
)


def __getattr__(name):
    # ilqr.py imports the kernel wrappers, which import trajectory/costs.py:
    # its names load on first use, not with the package
    if name in ("ILQRConfig", "ilqr_solve"):
        from nimblephysics_tpu_torch.trajectory import ilqr
        return getattr(ilqr, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
