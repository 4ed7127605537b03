"""nimblephysics_tpu_torch: the PyTorch/CUDA port of nimblephysics_tpu.

The port imports torch and never jax or the JAX package. Entry points take
``device=`` and default to ``"cuda"``; they raise where CUDA is missing
unless ``device="cpu"`` is given, which runs the plain PyTorch versions of
the kernels.
"""

from nimblephysics_tpu_torch.models.model import Model, State, build_model, relax_limits, zero_state

__all__ = ["Model", "State", "build_model", "relax_limits", "zero_state"]
