"""The port's kernels, each a ``ref.py`` plain PyTorch version, a
``kernel.py`` wrapper of its hand-written CUDA kernel (``csrc/*.cu``) and an
``ops.py`` entry that dispatches by the tensor's device: the three paged
attention kernels of the continuous-batching path, and RMSNorm, dense flash
attention and the Mamba2 SSD scan of the Zamba2 static path. Flash
attention and the three paged kernels (``attention_route``) and the SSD
scan (``ssd_route``) pick their kernel by dtype and count launches per
route. RMSNorm and flash attention also have backward kernels of the port's
own (``rmsnorm_bwd``, by D; ``flash_attention_bwd``, by dtype through
``attention_bwd_route``), which their ``ops`` entries call through
``torch.autograd.Function``s when a gradient is wanted."""
from ._cuda import attention_bwd_route, attention_route, ssd_route
from .decode_attention import (default_num_splits, flash_decode_fwd,
                               paged_decode_attention, paged_decode_reference)
from .flash_attention import (attention_bwd_reference,
                              attention_lse_reference, attention_reference,
                              flash_attention, flash_attention_bwd,
                              flash_attention_fwd)
from .kv_quant import dequantize_rows, quantize_pool, quantize_rows
from .mamba_scan import mamba_chunk_scan, ssd_chunked_reference, ssd_scan
from .prefill_attention import (flash_prefill_fwd, paged_prefill_attention,
                                paged_prefill_reference)
from .rmsnorm import (rmsnorm, rmsnorm_bwd, rmsnorm_bwd_reference,
                      rmsnorm_fused, rmsnorm_reference)
from .verify_attention import (flash_verify_fwd, paged_verify_attention,
                               paged_verify_reference)

# The launch counters of every CUDA kernel wrapper, by kernel name.
KERNEL_WRAPPERS = {"flash_decode_fwd": flash_decode_fwd,
                   "flash_prefill_fwd": flash_prefill_fwd,
                   "flash_verify_fwd": flash_verify_fwd,
                   "rmsnorm_fused": rmsnorm_fused,
                   "flash_attention_fwd": flash_attention_fwd,
                   "ssd_scan": ssd_scan,
                   "rmsnorm_bwd": rmsnorm_bwd,
                   "flash_attention_bwd": flash_attention_bwd}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def launch_counts_by_route() -> dict[str, dict[str, int]]:
    """{kernel: {route: launches}} for the wrappers that pick a kernel by
    dtype (flash attention forward and backward; paged decode, prefill and
    verify; the SSD scan) or by D (RMSNorm's backward)."""
    return {name: dict(fn.launches_by_route)
            for name, fn in KERNEL_WRAPPERS.items()
            if hasattr(fn, "launches_by_route")}


__all__ = ["default_num_splits", "flash_decode_fwd", "flash_prefill_fwd",
           "flash_verify_fwd", "paged_decode_attention",
           "paged_prefill_attention", "paged_verify_attention",
           "paged_decode_reference", "paged_prefill_reference",
           "paged_verify_reference", "quantize_rows", "dequantize_rows",
           "quantize_pool", "rmsnorm", "rmsnorm_fused", "rmsnorm_reference",
           "flash_attention", "flash_attention_fwd", "attention_reference",
           "flash_attention_bwd", "attention_bwd_reference",
           "attention_lse_reference", "rmsnorm_bwd", "rmsnorm_bwd_reference",
           "mamba_chunk_scan", "ssd_scan", "ssd_chunked_reference",
           "KERNEL_WRAPPERS", "reset_launch_counts",
           "launch_counts", "launch_counts_by_route", "attention_route",
           "attention_bwd_route", "ssd_route"]
