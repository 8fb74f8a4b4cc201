from . import adamw, grad_compress
from .adamw import AdamWConfig
from .train_step import (build_decode_step, build_fused_spec_step,
                         build_paged_decode_step, build_paged_prefill_step,
                         build_paged_verify_step, build_prefill_ragged_step,
                         build_prefill_step, build_train_step)
from .trainer import ElasticTrainer, Revoked, TrainerReport

__all__ = ["adamw", "grad_compress", "AdamWConfig", "build_train_step",
           "build_prefill_step", "build_decode_step",
           "build_prefill_ragged_step", "build_paged_decode_step",
           "build_paged_prefill_step", "build_paged_verify_step",
           "build_fused_spec_step", "ElasticTrainer", "Revoked",
           "TrainerReport"]
