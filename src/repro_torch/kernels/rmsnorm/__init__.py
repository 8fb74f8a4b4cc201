from .kernel import rmsnorm_bwd, rmsnorm_fused
from .ops import RMSNorm, rmsnorm
from .ref import rmsnorm_bwd_reference, rmsnorm_reference

__all__ = ["RMSNorm", "rmsnorm", "rmsnorm_bwd", "rmsnorm_bwd_reference",
           "rmsnorm_fused", "rmsnorm_reference"]
