"""Wrapper of the fused RMSNorm CUDA kernels.

Replaces ``repro/kernels/rmsnorm/kernel.py::rmsnorm_fused``. Both kernels
(``csrc/rmsnorm.cu``) run one block a row, read each element once and write
it once, and take any row count (no ``rows % block_rows`` contract). The
wrapper picks one by D (``rmsnorm_path``):

- ``"registers"``: D up to 1024 vectors of 16 bytes (8192 bf16, 4096 f32):
  the block is sized to D and each thread holds one vector of the row in
  registers, its loads all issued before the reduction -- the kernel of
  decode's 1-8 rows of 2048 or 4096;
- ``"smem"``: larger D, up to ``MAX_D``: 256 threads stage the row in
  shared memory as f32.

``rmsnorm_bwd`` wraps the port's own backward kernels (no TPU counterpart:
the reference differentiates its jnp rmsnorm with XLA), picked by D as the
forward's are and counted by that path (``launches_by_route``):
``"registers"`` keeps a row's x and g and each thread's dw partial in
registers (16-byte loads, the next row's in flight), ``"smem"`` walks the
row twice from memory; both recompute r from x, and a second launch sums
the blocks' f32 dw partials in a fixed order, so the same inputs give the
same bits.
"""
from __future__ import annotations

import torch

from .. import _cuda, _meta
from .ref import rmsnorm_bwd_reference, rmsnorm_reference

MAX_D = 32768            # the shared-memory kernel stages the row as f32
MAX_VECTORS = 1024       # the register kernel: a 16-byte vector a thread


def rmsnorm_path(d: int, dtype) -> str:
    """The kernel a row of ``d`` elements of ``dtype`` takes."""
    per_vector = 16 // (2 if dtype == torch.bfloat16 else 4)
    return "registers" if -(-d // per_vector) <= MAX_VECTORS else "smem"


@_meta.route(rmsnorm_reference)
def rmsnorm_fused(x, weight, eps: float = 1e-6):
    """x: (..., D) f32/bf16; weight: (D,) -> same shape and dtype as x.
    CUDA tensors, or meta ones (``_meta``)."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    w = weight.float().contiguous()
    _cuda.check_cuda("rmsnorm_fused", x2, w)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rmsnorm_fused: dtype {x.dtype} not f32/bf16")
    if w.shape != (d,) or not 1 <= d <= MAX_D or x2.shape[0] < 1:
        raise ValueError(f"rmsnorm_fused: x{tuple(x.shape)} weight"
                         f"{tuple(weight.shape)}; need 1 <= D <= {MAX_D}")
    out = torch.empty_like(x2)
    lib = _cuda.library("rmsnorm.cu")
    fn = (lib.rmsnorm_reg_fwd if rmsnorm_path(d, x.dtype) == "registers"
          else lib.rmsnorm_smem_fwd)
    rc = fn(x2.data_ptr(), _cuda.DTYPE_CODES[x.dtype], w.data_ptr(),
            out.data_ptr(), x2.shape[0], d, float(eps), _cuda.stream_of(x2))
    _cuda.raise_on(rc, "rmsnorm_fused")
    rmsnorm_fused.launches += 1
    return out.reshape(x.shape)


rmsnorm_fused.launches = 0

# Blocks of the backward's dx pass, each a dw partial row: at most four an
# SM (the register kernel launches no more than are resident).
BWD_BLOCKS = 4 * 132


@_meta.route(rmsnorm_bwd_reference)
def rmsnorm_bwd(x, weight, g, eps: float = 1e-6):
    """Gradients of ``rmsnorm_fused(x, weight, eps)`` for the output
    gradient ``g`` (x's shape and dtype) -> (dx like x, dw (D,) in the
    weight's dtype). Two launches (dx with the dw partials, then their
    reduction), counted as one, on the kernel of ``rmsnorm_path``. CUDA
    tensors, or meta ones (``_meta``)."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    g2 = g.reshape(-1, d).contiguous()
    w = weight.float().contiguous()
    _cuda.check_cuda("rmsnorm_bwd", x2, w, g2)
    if x.dtype not in (torch.float32, torch.bfloat16) or g.dtype != x.dtype \
            or g.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd: x{tuple(x.shape)} {x.dtype}, "
                         f"g{tuple(g.shape)} {g.dtype}; need one f32/bf16 "
                         f"shape and dtype")
    rows = x2.shape[0]
    if w.shape != (d,) or not 1 <= d <= MAX_D or rows < 1:
        raise ValueError(f"rmsnorm_bwd: x{tuple(x.shape)} weight"
                         f"{tuple(weight.shape)}; need 1 <= D <= {MAX_D}")
    nparts = min(rows, BWD_BLOCKS)
    dx = torch.empty_like(x2)
    part = torch.empty((nparts, d), dtype=torch.float32, device=x2.device)
    dw = torch.empty(d, dtype=torch.float32, device=x2.device)
    path = rmsnorm_path(d, x.dtype)
    lib = _cuda.library("rmsnorm.cu")
    fn = lib.rmsnorm_bwd_reg if path == "registers" else lib.rmsnorm_bwd_smem
    rc = fn(x2.data_ptr(), _cuda.DTYPE_CODES[x.dtype], w.data_ptr(),
            g2.data_ptr(), dx.data_ptr(), part.data_ptr(), nparts,
            dw.data_ptr(), rows, d, float(eps), _cuda.stream_of(x2))
    _cuda.raise_on(rc, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    rmsnorm_bwd.launches_by_route[path] += 1
    return dx.reshape(x.shape), dw.to(weight.dtype)


rmsnorm_bwd.launches = 0
rmsnorm_bwd.launches_by_route = {"registers": 0, "smem": 0}
