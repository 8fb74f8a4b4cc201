from . import (arctic_480b, internlm2_1_8b, mistral_nemo_12b, olmoe_1b_7b,
               starcoder2_7b, yi_6b, zamba2_1_2b)
from .base import ModelConfig, torch_dtype

_MODULES = {
    "arctic-480b": arctic_480b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "mistral-nemo-12b": mistral_nemo_12b,
    "starcoder2-7b": starcoder2_7b,
    "yi-6b": yi_6b,
    "internlm2-1.8b": internlm2_1_8b,
    "zamba2-1.2b": zamba2_1_2b,
}
ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCH_NAMES}")
    return _MODULES[name].CONFIG


def get_reduced_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCH_NAMES}")
    return _MODULES[name].reduced()


__all__ = ["ARCH_NAMES", "ModelConfig", "get_config", "get_reduced_config",
           "torch_dtype"]
