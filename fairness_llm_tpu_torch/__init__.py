"""PyTorch/CUDA port of the fairness study's decode path, for NVIDIA Hopper.

The JAX package ``fairness_llm_tpu`` is the reference; this package mirrors
its module names so each counterpart is easy to find. It imports ``torch``
and numpy only, never JAX, flax or the reference package.

Entry points take ``device=None``, which means CUDA, and raise when no card
is present. They run on the CPU only when the caller passes ``device="cpu"``
(the tests do); there, every hand-written kernel is replaced by its plain
PyTorch version in the same module.
"""

from fairness_llm_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
