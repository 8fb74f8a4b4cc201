"""Model configuration for the PyTorch port.

The port keeps its own copy of the reference ``ModelConfig``: the fields the
transformer's (dense, with experts, and with the audio and VLM frontends),
xLSTM's and the Zamba2 hybrid's serving and training paths and the
distributed layer read, with the ``dtype`` strings mapped to torch dtypes;
and of its ``ShapeConfig``: the four shapes every architecture is dry-run
at (``SHAPES``) and the skip rules (``runnable``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; choose from "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | audio | ssm | vlm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512        # GShard dispatch group size (tokens)
    moe_impl: str = "einsum"         # "einsum" (GShard one-hot) | "sort"
    moe_dense_ff: int = 0            # Arctic: parallel dense-residual FFN width
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2

    # --- SSM (Mamba2; xLSTM reads ssm_conv) ----------------------------------
    ssm_variant: str = ""            # "mamba2" | "xlstm"
    ssm_state: int = 0               # N (d_state)
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128             # SSD chunk length
    ssm_conv: int = 4                # short conv window

    # --- hybrid (Zamba2) -----------------------------------------------------
    shared_attn_every: int = 0       # apply the shared attention block every k layers

    # --- FFN ------------------------------------------------------------------
    mlp_gated: bool = True           # SwiGLU/GeGLU vs plain 2-matrix FFN
    mlp_act: str = "silu"            # "silu" | "gelu"

    # --- attention / positions -----------------------------------------------
    causal: bool = True
    encoder_only: bool = False
    rope_theta: float = 10_000.0
    # "chunked" | "dense" | "pallas" | "ring", as in the reference. Only
    # "ring" changes the port's behaviour: under sharding rules whose mesh
    # has a "model" axis, the training and prefill attention runs as ring
    # attention over it (distributed/ring_attention.py); every other value
    # runs the flash-attention kernel.
    attn_impl: str = "chunked"

    # --- serving (paged KV cache / continuous batching) ------------------------
    page_size: int = 16              # KV rows per physical cache page
    max_decode_slots: int = 8        # concurrent requests the serve engine admits
    prefill_chunk: int = 32          # query tokens per paged-prefill step
    enable_prefix_cache: bool = True # share prompt-prefix pages copy-on-write
    # Gateway decode preemption: an otherwise-infeasible interactive request
    # may pause the latest-deadline batch-class slot (pages pinned, resumed
    # with zero re-prefill). Read by the serving launcher when it builds the
    # gateway's DeadlineCostPolicy.
    enable_decode_preemption: bool = True
    enable_spec_decode: bool = False
    spec_tokens: int = 4             # drafted tokens per verify step (K)
    spec_ngram: int = 2              # draft key: 2 = bigram, 3 = trigram
    # split-KV decode: splits ~ decode_split_budget / batch (see
    # kernels.decode_attention.ops.default_num_splits)
    decode_split_budget: int = 32
    decode_chunk_tokens: int = 256   # target slots * decode_chunk product
    decode_chunk_min: int = 8
    decode_chunk_max: int = 32
    # "f32" keeps pool pages in ``dtype``; "int8" stores per-row symmetric
    # int8 with f32 scale pages (kernels/kv_quant.py).
    kv_cache_dtype: str = "f32"
    spec_adaptive_k: bool = False

    # --- modality frontend stub (audio / vlm) ---------------------------------
    frontend: str = ""               # "" | "frame" | "patch"
    frontend_dim: int = 0            # 512 (HuBERT features) / 1152 (SigLIP)
    frontend_len: int = 0            # image patches per example (PaliGemma: 256)

    # --- numerics / execution ---------------------------------------------------
    norm_eps: float = 1e-6
    # activation/compute dtype; serving stores matrix weights in it, and
    # every weight is cast to it at its use
    dtype: str = "bfloat16"
    # training's master weights (``init_params(..., dtype=)``)
    param_dtype: str = "float32"
    logit_dtype: str = "float32"
    # "none" | "full" (one torch.utils.checkpoint a layer) | "dots" (the
    # reference's policy that saves matmul outputs; not ported yet)
    remat: str = "none"
    logit_chunk: int = 0             # chunk the loss over seq (0 = off)
    tie_embeddings: bool = False

    # --- per-arch sharding rule overrides (logical axis -> mesh axis name) ------
    sharding_overrides: dict = field(default_factory=dict, hash=False,
                                     compare=False)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: heads {self.num_heads} not a multiple "
                             f"of kv heads {self.num_kv_heads}")
        if self.kv_cache_dtype not in ("f32", "int8"):
            raise ValueError(f"{self.name}: kv_cache_dtype must be 'f32' or "
                             f"'int8', got {self.kv_cache_dtype!r}")

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- derived sizes ----------------------------------------------------------
    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Total parameters, from the layout alone."""
        from ..models.registry import count_params  # lazy: no import cycle
        return count_params(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: the routed experts only)."""
        from ..models.registry import count_params
        return count_params(self, active_only=True)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int         # train/prefill: sequence length; decode: KV-cache length
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The assigned LM-family shape set (the same four for every architecture).
TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """The skip rules: (runnable, the reason where it is not)."""
    if cfg.encoder_only and shape.is_decode:
        return False, "encoder-only arch has no autoregressive decode step"
    full_attention = cfg.family in ("dense", "moe", "vlm", "audio")
    if shape.name == "long_500k" and full_attention:
        return False, ("pure full-attention arch; long_500k requires "
                       "sub-quadratic")
    return True, ""
