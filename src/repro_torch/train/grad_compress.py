"""Gradient compression with error feedback, the local part.

Int8 block quantization of a gradient tree with error-feedback residuals
(Seide et al. 2014 / EF-SGD, Karimireddy et al. 2019): the quantization
error is carried to the next step, so compressed SGD converges at the
uncompressed rate. A counterpart of the reference's
``repro/train/grad_compress.py``; ``compressed_psum`` is the cross-pod
all-reduce of the compressed gradients over a ``torch.distributed`` group.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from .adamw import dequantize_blockwise, quantize_blockwise, tree_map


class CompressorState(NamedTuple):
    residual: Any  # tree matching grads (float32)


def init_compressor(grads_like) -> CompressorState:
    return CompressorState(tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def compress_decompress(x):
    """Round-trip int8 block quantization: returns (x_hat, error)."""
    xq = quantize_blockwise(x.float())
    x_hat = dequantize_blockwise(xq)
    return x_hat, x.float() - x_hat


def ef_step(grads, state: CompressorState):
    """Error-feedback compression of a gradient tree (local part).

    Returns (compressed grads to be reduced, new state)."""
    outs = tree_map(lambda g, r: compress_decompress(g.float() + r), grads,
                    state.residual)
    g_hat = tree_map(lambda o: o[0], outs)
    resid = tree_map(lambda o: o[1], outs)
    return g_hat, CompressorState(resid)


def compressed_psum(grads, group, state: CompressorState):
    """Error-feedback int8 compression (``ef_step``), then the mean of the
    compressed gradients over ``group`` (a ``ProcessGroup``; None is the
    default group): an all-reduce sum divided by the group's size. Returns
    (reduced grads, new state). Meant for the cross-pod reduction; the
    intra-pod ones stay full precision."""
    g_hat, new_state = ef_step(grads, state)
    size = dist.get_world_size(group)

    def reduce(g):
        dist.all_reduce(g, group=group)
        return g / size

    return tree_map(reduce, g_hat), new_state
