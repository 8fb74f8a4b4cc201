from .params import init_params, params_from_reference
from .registry import count_params, get_family

__all__ = ["count_params", "get_family", "init_params",
           "params_from_reference"]
