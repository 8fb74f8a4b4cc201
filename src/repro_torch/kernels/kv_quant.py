"""Symmetric per-row int8 quantization for the paged KV pool.

Same layout and arithmetic as the reference: pool ``k``/``v`` are
(L, KV, P, page_size, head_dim) int8 and ``k_scale``/``v_scale`` are
(L, KV, P, page_size) f32, one scale per row. ``scale = amax / 127`` and the
row is DIVIDED by its scale, then rounded half to even (``torch.round``
rounds half to even, like ``jnp.round``), so int8 rows are bit-identical to
the reference's on the CPU. The paged attention kernels dequantize at tile
load and accumulate in f32.
"""
from __future__ import annotations

import torch

# Scale floor: an all-zero row (e.g. the untouched sink page) quantizes to
# zeros with this scale instead of dividing by zero.
SCALE_EPS = 1e-12
QMAX = 127.0


def quantize_rows(x: torch.Tensor):
    """(..., hd) float -> ((..., hd) int8, (...,) f32 per-row scales)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(SCALE_EPS) / QMAX
    q = torch.round(xf / scale[..., None]).clamp(-QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """((..., hd) int8, (...,) f32) -> (..., hd) f32."""
    return q.float() * scale[..., None]


def quantize_pool(pool_f32: dict) -> dict:
    """Quantize a whole float pool {"k","v"} into the int8 + scales layout
    {"k", "v", "k_scale", "v_scale"} (test/bench helper; serving quantizes
    row by row on scatter)."""
    out = {}
    for name in ("k", "v"):
        q, s = quantize_rows(pool_f32[name])
        out[name] = q
        out[name + "_scale"] = s
    return out
