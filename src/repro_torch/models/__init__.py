from .params import init_params, params_from_reference
from .registry import get_family

__all__ = ["get_family", "init_params", "params_from_reference"]
