from .train_step import (build_decode_step, build_fused_spec_step,
                         build_paged_decode_step, build_paged_prefill_step,
                         build_paged_verify_step, build_prefill_ragged_step,
                         build_prefill_step)

__all__ = ["build_prefill_step", "build_decode_step",
           "build_prefill_ragged_step", "build_paged_decode_step",
           "build_paged_prefill_step", "build_paged_verify_step",
           "build_fused_spec_step"]
