"""AdamW with optional int8 block-quantized moments.

A counterpart of the reference's ``repro/train/adamw.py``:

- decoupled weight decay, bias-corrected moments, global-norm clipping;
- linear-warmup + cosine-decay schedule;
- ``state_dtype="int8"``: both moments stored as int8 codes with one f32
  scale per block of ``QBLOCK`` values along the last axis (``v`` in the
  sqrt domain), 4x less optimizer memory; tensors under ``QUANT_MIN_SIZE``
  elements (norm gains) or whose last axis is not a multiple of ``QBLOCK``
  stay f32. Quantization error is bounded by scale/2 per element.

Parameters, gradients and moments are nested dicts of tensors on the
parameters' device (a moment leaf is a tensor or a :class:`QTensor`); the
sharded train step gives this rank's shards of each (``init``'s
``shapes``, ``update``'s ``reduce_sq``). The
arithmetic follows the reference's order in f32. ``update`` writes the new
parameters into the parameter tensors IN PLACE (the reference returns a
new tree): at full width a second copy of the f32 master weights would
cost as much memory as the weights themselves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

QBLOCK = 128

#: tensors smaller than this stay float32 even under int8 states
#: (norm gains, biases — negligible memory, high sensitivity).
QUANT_MIN_SIZE = 2048


# ---------------------------------------------------------------------------
# Block quantization
# ---------------------------------------------------------------------------

class QTensor:
    """int8 block-quantized tensor: ``q`` int8 (..., n_blocks, QBLOCK),
    ``scale`` f32 (..., n_blocks, 1), ``shape`` the logical shape."""

    def __init__(self, q, scale, shape):
        self.q = q
        self.scale = scale
        self.shape = tuple(shape)

    def __repr__(self):
        return f"QTensor(shape={self.shape})"


def quantize_blockwise(x) -> QTensor:
    """Blocks tile the LAST axis (which must be a multiple of QBLOCK),
    keeping the leading axes."""
    shape = tuple(x.shape)
    last = shape[-1] if shape else 1
    if last % QBLOCK:
        raise ValueError(f"last dim {last} % QBLOCK {QBLOCK} != 0")
    blocks = x.float().reshape(*shape[:-1], last // QBLOCK, QBLOCK)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = scale.clamp_min(1e-20)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale, shape)


def dequantize_blockwise(qt: QTensor) -> torch.Tensor:
    return (qt.q.float() * qt.scale).reshape(qt.shape)


# ---------------------------------------------------------------------------
# Trees (nested dicts)
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """Leaves in the order of the dicts' keys (tensors or QTensors)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"     # "float32" | "int8"


def lr_at(cfg: AdamWConfig, step, device=None) -> torch.Tensor:
    """The learning rate at ``step`` as an f32 scalar tensor."""
    step = torch.as_tensor(step, dtype=torch.float32, device=device)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clip((step - cfg.warmup_steps)
                      / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.learning_rate * warm * cos


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the parameters' device
    m: Any               # tree of tensors or QTensors
    v: Any


def _quantized(cfg: AdamWConfig, shape: tuple[int, ...]) -> bool:
    """A moment of a leaf of this (whole) shape is stored int8."""
    return (cfg.state_dtype == "int8" and math.prod(shape) >= QUANT_MIN_SIZE
            and not (shape and shape[-1] % QBLOCK))


def _encode(x, sqrt_domain: bool = False):
    if sqrt_domain:  # v >= 0: quantize sqrt(v) — compresses the dynamic range
        return quantize_blockwise(torch.sqrt(x))
    return quantize_blockwise(x)


def _decode(x, sqrt_domain: bool = False):
    if not isinstance(x, QTensor):
        return x
    d = dequantize_blockwise(x)
    return d * d if sqrt_domain else d


def _paths(tree, prefix: str = ""):
    """A tree of every leaf's path ("layers/attn/wq")."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}{k}/") for k, v in tree.items()}
    return prefix[:-1]


def init(cfg: AdamWConfig, params, shapes=None) -> AdamWState:
    """Zero moments for ``params``. ``shapes`` (a tree of tuples) gives the
    whole leaves' shapes where ``params`` are shards: whether a moment is
    int8 is decided on the whole leaf, as on one device, and a shard's
    blocks are the whole leaf's when its last dimension is a multiple of
    ``QBLOCK`` (raises otherwise, naming the leaf)."""
    if cfg.state_dtype not in ("float32", "int8"):
        raise ValueError(f"unknown state_dtype {cfg.state_dtype!r}")
    if shapes is None:
        shapes = tree_map(lambda p: tuple(p.shape), params)

    def moment(p, shape, path, sqrt_domain):
        x = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if not _quantized(cfg, tuple(shape)):
            return x
        if p.shape[-1] % QBLOCK:
            raise ValueError(
                f"{path}: int8 moments need the shard's last dimension "
                f"({p.shape[-1]} of {shape[-1]}) to be a multiple of QBLOCK "
                f"{QBLOCK}")
        return _encode(x, sqrt_domain)

    dev = tree_leaves(params)[0].device
    paths = _paths(params)
    return AdamWState(
        torch.zeros((), dtype=torch.int32, device=dev),
        tree_map(lambda p, s, n: moment(p, s, n, False), params, shapes,
                 paths),
        tree_map(lambda p, s, n: moment(p, s, n, True), params, shapes,
                 paths))


def global_norm(tree, reduce_sq=None) -> torch.Tensor:
    """The L2 norm over every leaf. ``reduce_sq`` (the sharded step's
    ``ShardedParams.reduce_sq``) sums the leaves' stacked sums of squares
    over the ranks that hold other parts of them."""
    sq = torch.stack([torch.sum(torch.square(x.float()))
                      for x in tree_leaves(tree)])
    if reduce_sq is not None:
        sq = reduce_sq(sq)
    return torch.sqrt(torch.sum(sq))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params,
           reduce_sq=None):
    """Returns (params, new_state, metrics); ``params``' tensors hold the
    updated values (in place). A moment stays int8 or f32 as ``init`` made
    it. ``reduce_sq``: as ``global_norm``'s, for shards."""
    step = state.step + 1
    gnorm = global_norm(grads, reduce_sq)
    clip = torch.clamp(cfg.max_grad_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    lr = lr_at(cfg, step, device=gnorm.device)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    def leaf(p, g, m_enc, v_enc):
        g = g.float() * clip
        m = cfg.b1 * _decode(m_enc) + (1 - cfg.b1) * g
        v = cfg.b2 * _decode(v_enc, sqrt_domain=True) + (1 - cfg.b2) * g * g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        upd = upd + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
        if isinstance(m_enc, QTensor):
            return _encode(m), _encode(v, sqrt_domain=True)
        return m, v

    out = tree_map(lambda p, g, m, v: leaf(p, g, m, v), params, grads,
                   state.m, state.v)
    new_m = tree_map(lambda o: o[0], out)
    new_v = tree_map(lambda o: o[1], out)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, new_m, new_v), metrics
