"""Model-family registry: the port runs the dense transformer only."""
from __future__ import annotations

from .transformer import TransformerFamily

_TRANSFORMER = TransformerFamily()


def get_family(cfg):
    if cfg.family == "dense":
        return _TRANSFORMER
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} is not ported yet; the MoE, SSM "
        "and other families come after the control-plane slice (ROADMAP.md, "
        "Queue 1)")
