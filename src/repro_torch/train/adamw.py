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
``shapes``, ``update``'s ``reduce_sq``). An int8 moment of a shard whose
last dimension is a multiple of ``QBLOCK`` is the shard's own blocks (the
whole leaf's blocks); any other int8 moment of a shard is held at the
reference's placement, its last dimension whole, and updated from the
gradient gathered whole over that dimension (``update``'s
``gather_last``, one function a leaf): block for block what the reference quantizes. The
arithmetic follows the reference's order in f32. ``update`` writes the new
parameters into the parameter tensors IN PLACE (the reference returns a
new tree): at full width a second copy of the f32 master weights would
cost as much memory as the weights themselves. A moment larger than
``UPDATE_ELEMS`` is updated a slice at a time.
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


def moment_shape(cfg: AdamWConfig, local: tuple[int, ...],
                 whole: tuple[int, ...]) -> tuple[int, ...]:
    """The logical shape of a moment of a parameter shard ``local`` of the
    leaf ``whole``: the shard's, except for an int8 moment whose shard's
    last dimension is not a multiple of ``QBLOCK``, which is held as the
    reference places it, the leading dimensions the shard's and the last
    dimension whole (repeated on every rank that shards it)."""
    if _quantized(cfg, whole) and local[-1] % QBLOCK:
        return tuple(local[:-1]) + (whole[-1],)
    return tuple(local)


#: The most elements of a moment that ``update`` takes at once: a larger
#: leaf (a stacked expert weight) is updated a slice of its leading
#: dimensions at a time, so its f32 temporaries stay at one slice's size.
#: The update is elementwise and the blocks tile the last dimension, so the
#: slices give the whole leaf's bits.
UPDATE_ELEMS = 1 << 26


def _pieces(shape: tuple[int, ...], limit: int):
    """Index tuples over the leading dimensions of ``shape`` (never the
    last) whose slices hold at most ``limit`` elements where they can: runs
    of the first dimension, or single indices of it and the next
    dimension's pieces; ``()`` for a shape within it."""
    if len(shape) <= 1 or math.prod(shape) <= limit:
        yield ()
        return
    inner = math.prod(shape[1:])
    if inner <= limit:
        run = limit // inner
        for i in range(0, shape[0], run):
            yield (slice(i, min(i + run, shape[0])),)
        return
    for i in range(shape[0]):
        for rest in _pieces(shape[1:], limit):
            yield (i,) + rest


def _index(x, idx):
    if isinstance(x, QTensor):
        q = x.q[idx]
        return QTensor(q, x.scale[idx], tuple(q.shape[:-2]) + x.shape[-1:])
    return x[idx]


def _empty_like(x):
    if isinstance(x, QTensor):
        return QTensor(torch.empty_like(x.q), torch.empty_like(x.scale),
                       x.shape)
    return torch.empty_like(x)


def _assign(out, idx, x):
    if isinstance(out, QTensor):
        out.q[idx].copy_(x.q)
        out.scale[idx].copy_(x.scale)
    else:
        out[idx].copy_(x)


def _zero_codes(shape: tuple[int, ...], device) -> QTensor:
    """``quantize_blockwise`` of zeros (sqrt domain alike), without the f32
    zeros: codes 0, every scale the floor 1e-20."""
    blocks = (*shape[:-1], shape[-1] // QBLOCK)
    return QTensor(torch.zeros((*blocks, QBLOCK), dtype=torch.int8,
                               device=device),
                   torch.full((*blocks, 1), 1e-20, dtype=torch.float32,
                              device=device), shape)


def init(cfg: AdamWConfig, params, shapes=None) -> AdamWState:
    """Zero moments for ``params``. ``shapes`` (a tree of tuples) gives the
    whole leaves' shapes where ``params`` are shards: whether a moment is
    int8 is decided on the whole leaf, as on one device. A shard whose last
    dimension is a multiple of ``QBLOCK`` holds its own blocks, which are
    the whole leaf's; any other int8 moment is held at the reference's
    placement (``moment_shape``), and ``update`` needs its leaf's
    ``gather_last``."""
    if cfg.state_dtype not in ("float32", "int8"):
        raise ValueError(f"unknown state_dtype {cfg.state_dtype!r}")
    if shapes is None:
        shapes = tree_map(lambda p: tuple(p.shape), params)

    def moment(p, shape):
        local = moment_shape(cfg, tuple(p.shape), tuple(shape))
        if not _quantized(cfg, tuple(shape)):
            return torch.zeros(local, dtype=torch.float32, device=p.device)
        return _zero_codes(local, p.device)

    dev = tree_leaves(params)[0].device
    return AdamWState(
        torch.zeros((), dtype=torch.int32, device=dev),
        tree_map(moment, params, shapes), tree_map(moment, params, shapes))


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
           reduce_sq=None, gather_last=None):
    """Returns (params, new_state, metrics); ``params``' tensors hold the
    updated values (in place). A moment stays int8 or f32 as ``init`` made
    it. ``reduce_sq``: as ``global_norm``'s,
    for shards. ``gather_last``, a tree like ``params`` (the sharded step's
    ``ShardedParams.last_gathers``), holds one function a leaf that takes
    a shard of its gradient and gives it with its last dimension whole and
    this rank's offset in it, for a moment held at the reference's
    placement: every rank that holds it computes the same moments over the
    whole last dimension and applies its own block of the update to its
    shard."""
    step = state.step + 1
    gnorm = global_norm(grads, reduce_sq)
    clip = torch.clamp(cfg.max_grad_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    lr = lr_at(cfg, step, device=gnorm.device)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    def piece(p, g, m_enc, v_enc, gather):
        n, offset = p.shape[-1], None
        if m_enc.shape[-1:] != p.shape[-1:]:      # the reference's placement
            if gather is None:
                raise ValueError(f"a moment of last dimension "
                                 f"{m_enc.shape[-1]} beside a shard of "
                                 f"{n} needs gather_last")
            g, offset = gather(g)
        g = g.float() * clip
        m = cfg.b1 * _decode(m_enc) + (1 - cfg.b1) * g
        v = cfg.b2 * _decode(v_enc, sqrt_domain=True) + (1 - cfg.b2) * g * g
        enc = ((_encode(m), _encode(v, sqrt_domain=True))
               if isinstance(m_enc, QTensor) else (m, v))
        if offset is not None:
            m, v = m[..., offset:offset + n], v[..., offset:offset + n]
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        upd = upd + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
        return enc

    def leaf(p, g, m_enc, v_enc, gather):
        pieces = list(_pieces(tuple(m_enc.shape), UPDATE_ELEMS))
        if pieces == [()]:
            return piece(p, g, m_enc, v_enc, gather)
        new = (_empty_like(m_enc), _empty_like(v_enc))
        for idx in pieces:
            enc = piece(p[idx], g[idx], _index(m_enc, idx),
                        _index(v_enc, idx), gather)
            for out, x in zip(new, enc):
                _assign(out, idx, x)
        return new

    if gather_last is None:
        gather_last = tree_map(lambda _: None, params)
    out = tree_map(leaf, params, grads, state.m, state.v, gather_last)
    new_m = tree_map(lambda o: o[0], out)
    new_v = tree_map(lambda o: o[1], out)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, new_m, new_v), metrics
