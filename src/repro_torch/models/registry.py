"""Model-family registry: the dense transformer and the Zamba2 hybrid."""
from __future__ import annotations

from .transformer import TransformerFamily, ZambaFamily

_TRANSFORMER = TransformerFamily()
_ZAMBA = ZambaFamily()


def get_family(cfg):
    if cfg.family == "dense":
        return _TRANSFORMER
    if cfg.family == "hybrid" or cfg.ssm_variant == "mamba2":
        return _ZAMBA
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} is not ported yet; MoE and xLSTM "
        "come in later slices (ROADMAP.md, Queue 1)")
