"""World stepping: the differentiable timestep, rollouts and the World
facade."""

from nimblephysics_tpu_torch.simulation.world import Recording, World, timestep

__all__ = ["Recording", "World", "timestep"]
