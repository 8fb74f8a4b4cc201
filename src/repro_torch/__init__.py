"""PyTorch + CUDA port of the repro serving path.

The JAX package ``repro`` is the reference; this package imports nothing of
it (and never ``jax``). Entry points take ``device=`` and default to
``"cuda"``: they raise when CUDA is absent unless the caller asks for
``"cpu"``, where every kernel runs its plain PyTorch version.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
