from .kernel import rmsnorm_fused
from .ops import rmsnorm
from .ref import rmsnorm_reference

__all__ = ["rmsnorm", "rmsnorm_fused", "rmsnorm_reference"]
