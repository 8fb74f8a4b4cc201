from . import (arctic_480b, hubert_xlarge, internlm2_1_8b, mistral_nemo_12b,
               olmoe_1b_7b, paligemma_3b, starcoder2_7b, xlstm_350m, yi_6b,
               zamba2_1_2b)
from .base import (DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
                   ModelConfig, ShapeConfig, runnable, torch_dtype)

_MODULES = {
    "arctic-480b": arctic_480b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "mistral-nemo-12b": mistral_nemo_12b,
    "starcoder2-7b": starcoder2_7b,
    "yi-6b": yi_6b,
    "internlm2-1.8b": internlm2_1_8b,
    "zamba2-1.2b": zamba2_1_2b,
    "xlstm-350m": xlstm_350m,
    "hubert-xlarge": hubert_xlarge,
    "paligemma-3b": paligemma_3b,
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


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells():
    """Every (arch, shape) cell with its verdict: (arch, shape name,
    runnable, reason)."""
    out = []
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = runnable(cfg, shape)
            out.append((arch, shape.name, ok, why))
    return out


__all__ = ["ARCH_NAMES", "DECODE_32K", "LONG_500K", "ModelConfig",
           "PREFILL_32K", "SHAPES", "ShapeConfig", "TRAIN_4K", "all_cells",
           "get_config", "get_reduced_config", "get_shape", "runnable",
           "torch_dtype"]
