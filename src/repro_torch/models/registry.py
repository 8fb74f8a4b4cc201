"""Model-family registry and parameter accounting: the transformer (dense,
with experts, and with the audio and VLM frontends), xLSTM and the Zamba2
hybrid."""
from __future__ import annotations

from .params import count_params_in_layout
from .transformer import TransformerFamily, XLSTMFamily, ZambaFamily

_TRANSFORMER = TransformerFamily()
_XLSTM = XLSTMFamily()
_ZAMBA = ZambaFamily()


def get_family(cfg):
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        return _TRANSFORMER
    if cfg.family == "ssm" and cfg.ssm_variant == "xlstm":
        return _XLSTM
    if cfg.family == "hybrid" or cfg.ssm_variant == "mamba2":
        return _ZAMBA
    raise ValueError(f"no family for {cfg.name} "
                     f"({cfg.family}/{cfg.ssm_variant})")


def count_params(cfg, active_only: bool = False) -> int:
    """Total (or per-token active) parameter count from the layout alone.
    ``active_only`` scales every leaf with an experts axis and more than two
    dimensions by ``experts_per_token / num_experts``: the stacked expert
    weights and, as in the reference, the stacked router."""
    layout = get_family(cfg).layout(cfg)
    total = count_params_in_layout(layout)
    if not active_only or not cfg.num_experts:
        return total
    expert = count_params_in_layout(
        layout, predicate=lambda s: s.experts and len(s.shape) > 2)
    frac = cfg.experts_per_token / cfg.num_experts
    return int(total - expert + expert * frac)
