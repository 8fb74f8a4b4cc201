#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (a failure exits nonzero):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
   one process a source, all started together; print the registers and
   spills of the tensor-core (wgmma + TMA) instantiations the serve and
   training paths launch (the SSD scan's and the bf16 flash backward's
   among them), and fail if one spills; list the other backward kernels
   (the flash delta pass, the f32 CUDA-core flash backward, RMSNorm's) with
   their registers and spills, which are reported and not fatal;
3. kernels: each paged attention kernel with bf16 q on bf16 and int8 pools
   (the tensor-core route) at the yi-6b serve path's shapes and off them
   (G 4, page sizes 32 and 64; the prefill at C 13; decode and verify at
   one split, at 4 and 8, and at batch 1 with 32 one-page splits, lengths
   1, mid-page and full, verify windows of 1 to 8), and in f32 at the serve
   shapes (the CUDA-core route); RMSNorm, dense flash attention and the
   Mamba2 SSD scan at the Zamba2 serve path's shapes (B 8, S 256) in bf16
   (the SSD scan on the tensor-core route, also at S 40 in one chunk of
   40, S 384, B 1 and under strong decay) and f32 (the CUDA-core route;
   plus ragged, GQA, hd 256 and multi-chunk cases), the SSD scan in both
   also with a ragged last chunk (S 130 and 200 at chunk 128, S 40 at
   chunk 16), RMSNorm also at
   decode's rows (1 and 8 rows of 1000, 4097 and 32768; timed at 8 rows
   of 2048 and 4096 beside ``F.rms_norm``, and at 2048 rows on both its
   kernels); the paged kernels at olmoe-1b-7b's shapes (G 1), flash
   attention at the dense and MoE transformers' static prefill (B 8, S
   256, hd 128, G 1, 4 and 7, and a dense-admission bucket) and RMSNorm at
   D 5120 and 7168 (2048 and 8 rows), timed where new; each held
   against its plain PyTorch version on the same inputs and timed beside
   the plain version and one library call where there is one (``time_ms``:
   device time between two events, behind a spin kernel that outlasts the
   host's enqueue), and the paged kernels' host enqueue on both routes;
   then the backward kernels (flash attention's and RMSNorm's, the port's
   own) against autograd of their plain versions in bf16 and f32, each
   twice for bit equality: flash at internlm2-1.8b's training shape (B 8,
   S 1024, H 16, KV 8, hd 128, causal), at hd 64 G 1, G 7, a ragged S 1000
   and non-causal (bf16 on the tensor-core route, f32 on the CUDA-core
   one; a bf16 hd 192 call must raise), and at the frontends' training
   shapes (hubert-xlarge's B 8, S 1000, H = KV 16, hd 80, bidirectional,
   in bf16 and f32; paligemma-3b's B 8, S 512, H 8 over KV 1, hd 256,
   causal, in bf16; the forward's row log-sum-exp held there too); RMSNorm
   at 8192 x 2048, D 5120, 7168 and a ragged 1002 (each on the kernel its
   D picks); in bf16 both at phase 8c (b)'s local shapes (flash at B 16,
   S 4096, 1 head over 1, hd 128, causal; RMSNorm at 65536 x 2048), their
   forward kernels held to the plain version there too; the training
   shapes timed beside the plain version, the library's backward (SDPA,
   ``F.rms_norm``) and the bound, with each launch's device time; and
   the flash forward at that training shape, with and without the row
   log-sum-exp, beside causal SDPA and the bound;
4. parity: yi-6b widths at depth 2 in float32 -- prefill, decode and verify
   steps on the card (kernels) against the same weights on the CPU (plain
   versions); then Zamba2 widths at depth 6 (one Mamba group and one shared
   attention application), float32, batch 2, prompts of 256 and of 200
   (a ragged last SSD chunk), prefill and four decode steps, card against
   CPU; olmoe-1b-7b widths at depth 2 (the paged steps, and the static
   prefill and decode at S 256 and 300: 600 tokens leave a ragged MoE
   group) and mistral-nemo-12b widths at depth 2 (static, S 256 and 200);
5. serve: full-width yi-6b (32 layers, bf16, random weights from a seed)
   through ``ContinuousBatchingEngine.generate``: plain decode, speculative
   decode (K=4) and an int8 pool; then full-width Zamba2-1.2B (38 layers,
   bf16) through the static ``ServeEngine.generate``, 8 prompts of 160-256
   tokens, 32 new each, then untimed the same prompts cut to 200 tokens (a
   ragged last SSD chunk); full-width olmoe-1b-7b (16 layers, 64 experts
   top 8) through the continuous engine (plain, spec, int8) and the static
   one (timed, and untimed at 200: a ragged MoE group), full-width
   mistral-nemo-12b (40 layers) through the static engine and the
   continuous one with paged and dense admission (tokens equal, in bf16
   and again in f32), arctic-480b at full widths and depth 1 through the
   static engine (untimed), with tokens/s, peak device memory and each
   phase's seconds; each kernel's launch count read around each run (the
   static and dense-admission runs' flash and RMSNorm counts exact), and
   every bf16 flash-attention, SSD-scan and paged decode, prefill and
   verify launch required to take the tensor-core route (the f32 parity
   phases, the CUDA-core route);
6. residency: full-width yi-6b again at half depth (16 of 32 layers: token
   identity does not depend on the depth), bf16 and int8 pools, plain and
   speculative (K=4), each held exactly to its uninterrupted ``generate``:
   two requests preempted for a chunk and resumed; a live and a paused
   request exported (reason EVACUATE) and imported into a second engine;
   every finished stream demoted at retirement into a ``TieredKVStore``
   whose HOST tier holds about half of them, one restored from each tier
   into a fresh engine (bit for bit) and extended by a prompt that only
   prefills its suffix, held to a twin restored from a copy taken before
   the store held it (a fresh engine that recomputes the stream is
   compared and reported, not held); and the export and ``import_pages``
   of all 8 requests timed (plain engines);
7. gateway: ``KottaServeGateway`` over full-width yi-6b engines at half
   depth, as residency (one
   parameter tree for every replica, 8 slots, max_len 512, decode chunks of
   4), the serve phase's 8 prompts over two tenants in two waves, 32 new
   tokens: an undisturbed two-replica fleet (bf16 and int8 pools, plain
   and spec), the same trace with the busier replica revoked after its
   first chunk under a 120 s notice (every live request evacuated, tokens
   held exactly to the undisturbed fleet's, the evacuation timed against
   the notice), a notice too short to ship anything (requeue with
   backoff), a disaggregated 1:1 fleet, a tiered KV store restoring
   extensions of the first waves' streams, and an open-loop trace into a
   StateStore; rounds, wall a round and the host's share outside the
   engines' stepped API a scenario, the card's measured service rates
   beside ``ServiceModel``'s, and the phase's launches (every bf16 paged
   one on ``sm90``) and peak device memory.

8. train: the training path's f32 parity, card against CPU, at
   internlm2-1.8b, olmoe-1b-7b, hubert-xlarge and paligemma-3b widths
   (depth 2, B 2, S 256; hubert's 256 frames with a loss mask, paligemma's
   256 patches before 64 tokens: the f32 flash backward at hd 80 and 256;
   the loss within 1e-5 and every gradient within 1e-4 of its leaf's max); then
   full-width, full-depth internlm2-1.8b (24 layers, bf16 over f32 master
   weights, remat "full") trained by ``ElasticTrainer`` on a synthetic
   corpus in the port's ``ObjectStore``, batch 8 x 1024, int8 AdamW
   moments, 6 steps with checkpoints every 3, once uninterrupted and once
   revoked at step 4, under ``torch.use_deterministic_algorithms``: the
   two final states bit for bit equal, the loss falling, every step's
   launches exact (flash forward 2L and backward L, all on sm90; RMSNorm
   forward 4L + 1, backward 2L + 1 on its register kernel) and no plain
   version called; prints step ms,
   tokens/s, peak device memory and the checkpoints' save and restore
   seconds and GB/s, and the final state's SHA-256.
8b. launch: the launch layer's dry-run (``repro_torch.launch.dryrun``'s
   ``analyze_cell``: ``build_cell`` and ``step_analysis`` on meta
   tensors) of the train phase's own cell -- internlm2-1.8b at
   ``ShapeConfig("train_8x1k", "train", 1024, 8)`` on the (1, 1) card
   mesh, with the train phase's ``AdamWConfig`` (int8 moments) -- beside
   that phase's measured step: the predicted bytes a device against its
   peak device memory (failing beyond 3%), the traced matmul FLOPs
   against the model FLOPs, the roofline terms from ``H100_SXM`` against
   the measured step, the measured share of peak (model time / step
   time), and ``H100_SXM``'s memory against the card's; it fails if the
   trace dispatched anything on the card or launched a kernel.
8c. sharding: the sharded train step (``build_train_step(...,
   sharded=True)``: FSDP over "data", tensor parallelism over "model",
   explicit autograd collectives). (a) a one-process NCCL group and a
   (1, 1) ("data", "model") mesh, every collective issued over its one
   rank: full-width, full-depth internlm2-1.8b, B 8 x 1024, bf16 over f32
   masters, int8 moments, 3 steps under deterministic algorithms through
   ``shard_params`` and the sharded step, against the replicated step from
   the same weights and batches: losses, metrics and the final parameters
   (``gather_params``) equal bit for bit, every step's launches exactly the
   train phase's, every bf16 one on sm90, no plain version called; (b)
   rank 0 of the single-pod (16, 16) mesh over a fake process group of
   256 ranks: internlm2-1.8b ``train_4k`` (B 256 x 4096, rank 0's 16
   rows), only rank 0's shards allocated, 2 sharded steps: the measured
   peak device memory within 3% of the dry-run's sharded
   ``per_device_total`` for the same cell, every step's launches exact at
   the local shapes (flash at 1 query head over 1 KV head, hd 128, B 16,
   S 4096; RMSNorm over 65536 rows of 2048), all on sm90, where the
   backward-kernel checks held both kernels, forward and backward, to
   their plain versions in bf16 (``SHARD_LOCAL_FLASH``,
   ``SHARD_LOCAL_RMS``); prints the step's device ms beside the dry-run's
   compute and memory terms.
8d. expert parallel: the sharded MoE train step (experts over "model",
   FSDP over "data", the router gathered whole, one reduce of the experts'
   and Arctic's dense branch's partial outputs, the aux losses' token sums
   all-reduced over "data"). (a) the one-process NCCL (1, 1) mesh:
   full-width olmoe-1b-7b at depth 4 (64 experts top 8), B 8 x 1024 (16
   groups of 512), bf16 over f32 masters, int8 moments, 3 steps under
   deterministic algorithms, bit for bit the replicated step (losses,
   metrics, final parameters), launches exactly the replicated step's on
   sm90, no plain version called; (b) rank 0 of the (16, 16) mesh over a
   fake process group: olmoe-1b-7b ``train_4k`` at full depth, then
   arctic-480b ``train_4k`` (bf16 masters, int8 moments, some held at the
   reference's placement), only rank 0's shards allocated, 2 steps each:
   peak device memory within 3% of the dry-run's sharded
   ``per_device_total``, launches exact at the local shapes, all on sm90
   (arctic's flash at 56 heads over 8 and RMSNorm over 65536 x 7168 held
   to their plain versions in the backward-kernel checks, the flash at B
   2); each step's device ms beside the dry-run's terms.
8e. ssm sharding: the sharded Zamba2 and xLSTM train steps (Mamba2's
   SSD over the rank's heads with the fused projection and conv gathered
   whole over "model", its gated norm on gathered whole rows before a
   row-parallel output projection; the mLSTM column- then row-parallel
   around a recurrence every model rank repeats; the sLSTM on the rank's
   heads where they split; Zamba2's shared block as 8c's attention and
   FFN). (a) the one-process NCCL (1, 1) mesh: full-width zamba2-1.2b at
   depth 6 (one group and one shared application), B 8 x 1024, and (c)
   xlstm-350m at depth 2, B 8 x 256, each bf16 over f32 masters, int8
   moments, 3 steps under deterministic algorithms, bit for bit the
   replicated step (losses, metrics, final parameters), launches exactly
   the replicated step's (every bf16 SSD scan, its backward and flash on
   sm90), no plain version called; (b) rank 0 of the (16, 16) mesh over
   a fake process group: zamba2-1.2b ``train_4k``, all 38 layers, only
   rank 0's shards allocated, 2 steps: every kernel of the step first held
   to its plain version at rank 0's local shapes in bf16 (the SSD scan and
   its backward over 4 of the 64 heads at B 16 x 4096, flash over 2 heads
   at hd 64, RMSNorm over 65536 rows of 2048 and 4096), then the peak
   device memory within 3% of the dry-run's sharded ``per_device_total``,
   launches exact at those shapes, all on sm90; each step's device ms
   beside the dry-run's terms. xlstm-350m's ``train_4k`` on rank 0 waits
   for a fused sLSTM kernel (its plain time loop at S 4096).
8f. serve sharding: the transformer's sharded serve steps
   (``build_prefill_step`` / ``build_encode_step`` / ``build_decode_step``
   with ``sharded=True``: FSDP over "data", heads, FFN and experts over
   "model", vocab-parallel logits, the decode cache split by sequence,
   each rank's partial softmax combined over the split, the new K/V row
   written by its owner, a global argmax). (a) the one-process NCCL (1, 1)
   mesh at full width and depth 2: internlm2-1.8b's prefill of B 8 x 1024
   in bf16 and hubert-xlarge's encode of 8 x 1024 frames, bit for bit the
   replicated steps; internlm2-1.8b and olmoe-1b-7b in f32, 8 decode steps
   over the cache split by sequence over the one-rank "model" against the
   replicated decode: logits within 1e-5 relative, tokens and caches
   equal; launches exact, no plain version called; the kernels at (b)'s
   local shapes against their plain versions in bf16 (flash over 2 of
   mistral-nemo-12b's heads and their KV head at B 2 x 32768, hd 128, its
   first and last 1024 rows held; RMSNorm over 65536 x 5120, 8 x 5120 and
   8 x 2048); (b) rank 0 of the (16, 16) mesh over a fake process group:
   mistral-nemo-12b ``prefill_32k`` and ``decode_32k`` at all 40 layers
   and olmoe-1b-7b ``decode_32k``, only rank 0's shards, rows and cache
   block allocated, 2 steps each: the peak device memory within 1% of the
   dry-run's sharded ``per_device_total``, launches exact (flash on sm90),
   each step's device ms beside the dry-run's terms.
9. job: the same training run as a job of the Kotta batch runtime
   (``KottaService``): an outsider's submit refused and audited; alice's
   job staged under her role by the executor's assume-role, run on a
   preemptible worker, revoked through ``Worker.revoke()`` at step 4 and
   resumed by a replacement worker from the step-3 checkpoint, its
   outputs staged back as hers; held to the train phase's final-state
   SHA-256, its launches a step, no plain version, no watcher re-run and a
   clean shutdown; prints the job's wall, step ms, save and restore
   seconds, the time from the revocation to the second worker's first
   step, device memory at each attempt's start and the peak; then the
   port's simulator's Table VII-C rows (a simulation at 2016 prices).
10. zamba train: the SSD scan's backward kernels (the port's own)
   against the plain backward in bf16 (the wgmma + TMA kernels,
   ``csrc/ssd_scan_bwd_sm90.cu``, on the ``sm90`` route) and f32 (the
   CUDA-core walk on ``cuda_core``), each twice, bit for bit: at Zamba2's
   training shape (B 8, S 1024, H 64, N = P = 64, chunk 128), at S 1000
   and 200 (ragged last chunks) and at chunk 16, B 1, under strong decay
   with a nonzero dh_final (bf16 outputs within TOL_BF16, f32 ones --
   the bf16 route's ddt and da_log too -- within TOL_F32 of each
   gradient's max); the training shape timed beside the plain version and
   the bound (no library call), with each launch's device time. Then, under
   ``torch.use_deterministic_algorithms``, Zamba2 widths at depth 6 in
   f32, B 2, S 256, at SSD chunk 128 and 96 (ragged): ``train_loss`` and
   every gradient card against CPU (1e-5 / 1e-4 of each leaf's max),
   launches exact; and full-width zamba2-1.2b (38 Mamba2 layers, 6 shared
   applications, bf16 over f32 masters, remat full, int8 moments) trained
   by ``ElasticTrainer`` at B 8 x 1024, 4 steps with checkpoints every 2,
   once uninterrupted and once revoked after step 3: the final states'
   SHA-256 equal, the loss falling, every step's launches exact (SSD scan
   2L on sm90, its backward L on sm90, flash 6 and 6 on sm90, RMSNorm
   4L + 13 and 2L + 13) and no plain version called; step ms, tokens/s,
   peak memory, checkpoint GB and save/restore seconds; last, one such
   step under ``torch.profiler``: the device busy share of its wall and
   the ten kernels with the most device time.
11. xlstm: xlstm-350m widths at depth 2 in f32, card against CPU: prefill
   and four decode steps at prompts of 256 (four mLSTM chunks) and 200 (a
   ragged last chunk), logits and states within 1e-3; ``train_loss`` and
   every gradient at B 2, S 256 (the loss within 1e-5 of itself, each
   gradient within 1e-4 of its leaf's max); bf16 RMSNorm at the path's
   own shapes against its plain version (forward over 2048 and 8 rows,
   backward over 4096, at D 1024 and 2048, on the register kernel); then
   the full model (24 layers, 12 mLSTM/sLSTM pairs, bf16, random weights
   from seed 0)
   through the static ``ServeEngine``, the serve phase's 8 prompts of
   160-256 tokens, 32 new, after a warm-up, RMSNorm's launches exact (37 a
   pass, the register kernel's widths), and untimed at a longest prompt
   of 200; ``torch.profiler`` over a 256-token prefill and a decode step
   (launches, busy share, device time by kernel, the wall share inside
   ``slstm_scan``'s time loop); and training through
   ``ElasticTrainer`` at B 8 x 512 (remat full, int8 moments,
   checkpoints every 2) at depth 4, 4 steps, once uninterrupted and once
   revoked after step 3 (lost, and replayed from the step-2 checkpoint), under
   ``torch.use_deterministic_algorithms``: the two final states'
   SHA-256 equal, the loss falling, RMSNorm's 13 forward and 7 backward
   launches a step exact (2 pairs), no plain version called.
12. frontends: hubert-xlarge and paligemma-3b widths at depth 2 in f32,
   card against CPU: hubert's encode logits (B 2 x 200 frames) and
   paligemma's prefill of 256 patches + 16 tokens, three decode steps
   from pos 272 and the cache, within 1e-3 (flash at hd 80 and 256 on the
   CUDA-core route); full hubert-xlarge (48 layers, bf16) encoding 8 x
   1000 frames through ``build_encode_step`` (frames/s, peak memory,
   finite logits, flash 48 launches on sm90 at hd 80, RMSNorm 97) and
   profiled; full paligemma-3b (18 layers, bf16): a patch prefill of 8 x
   (256 + 32) and 32 decode steps from pos 288 (launches exact), then
   ``ServeEngine.generate`` (exact, profiled) and
   ``ContinuousBatchingEngine.generate`` (paged decode launches exact,
   every paged launch on sm90 at hd 256, G 8) over the serve phase's 8
   text prompts x 32 new. The kernels phase also holds flash at
   hubert's shape (B 8, S 1000, H 16, hd 80, full) in bf16 and f32, at
   paligemma's prefill (B 8, S 288, H 8 over KV 1, hd 256, causal) and
   the paged decode and prefill at hd 256, G 8, each timed beside SDPA
   and its bound.
13. frontend train: full-width hubert-xlarge at half depth (24 of 48
   layers, hd 80, bidirectional; 8 x 1000 frames labelled with the
   nearest of 504 fixed random centroids, a Bernoulli(0.3) loss mask) and
   paligemma-3b (9 of 18 layers, MQA at hd 256; 8 x (256 patches + 256
   tokens of the synthetic corpus), the text one logit chunk) trained by
   ``ElasticTrainer`` as the zamba train phase trains Zamba2: bf16 over
   f32 masters, remat full, int8 moments, 4 steps, checkpoints every 2,
   once uninterrupted and once revoked after step 3, under
   ``torch.use_deterministic_algorithms``: the final states' SHA-256
   equal, the loss falling, every step's launches exact (flash 2L and L,
   all on sm90; RMSNorm 4L + 1 and 2L + 1 on its register kernel) and no
   plain version called; step ms, positions/s, peak memory, checkpoint GB.
14. examples: the four ``repro_torch.examples`` on the card, each short:
   secure_analytics (alice's topics equal to a numpy count of the same
   shards, bob denied WOS with the deny audited, the Glacier path parked
   then COMPLETED, a clean shutdown), quickstart (the loss falls over 10
   steps), elastic_training (22 steps through the revocation at step 20)
   and serve_demo (4 prompts from weights restored bit for bit).
15. distributed: ring attention through the flash kernels
   (``ring_attention_single_device``, R 4 shards, bf16) at starcoder2-7b's
   attention width (H 36 over KV 4, hd 128, B 1), causal and full: at S
   32768 (8192 a shard) held to one whole-sequence flash forward and
   backward (out, dQ, dK, dV within TOL_BF16), at S 2048 to the plain
   versions, exactly 10 forward and 10 backward launches causal (the
   blocks in the future skipped), 16 and 16 full, all on sm90, and timed
   at S 32768 beside the whole-sequence kernels and the bound; then a
   one-process NCCL group and a (1, 1) ("data", "model") mesh under
   ``activate_rules``: full-width starcoder2-7b at depth 2, B 2 x S 4096,
   one ``build_loss_and_grads`` and one ``build_train_step`` step with
   ``attn_impl`` "ring" (every attention through
   ``ring_attention_sharded``) and "chunked" from the same weights, under
   deterministic algorithms: losses, every gradient and every updated
   parameter equal bit for bit, launches exact, no plain version; last,
   ``compressed_psum`` over that group equal to ``ef_step``.

The second-to-last line of output is a JSON ``kernels`` record (with the
launches on the transformer runs, the residency phase's move times, the
gateway phase's results, the train, job, zamba train and xlstm phases'
numbers, the launch phase's prediction, the sharding phase's runs (each
training kernel's launches in them as ``launches_sharding``),
``ssd_scan_bwd`` among the
kernels, each kernel's Zamba2
training launches as ``launches_zamba_train``, RMSNorm's xLSTM launches as
``launches_xlstm_serve`` and ``launches_xlstm_train``, each kernel's
launches in the frontends phase as ``launches_frontends``, in the
frontends' training as ``launches_frontend_train`` and in the distributed
phase as ``launches_distributed``, and the frontends, frontend train,
examples and distributed phases' numbers); the last is
``{"ok": true, "device": {...}}``. Without CUDA, or without the port
beside this script, it prints no result and exits nonzero. It takes no
arguments: every run drives all eighteen phases (8b, 8c and 8d among
them).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# The train phase runs under torch.use_deterministic_algorithms, where
# cuBLAS needs a fixed workspace, set before CUDA starts.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and bf16 tensor
# FLOP/s. The bound of a kernel is max(bytes / HBM, flops / bf16 peak).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# float32 outside the tensor cores (the CUDA-core kernels' route)
F32_FLOPS_PER_S = 67e12

# yi-6b serving shapes (configs/yi_6b.py): heads, kv heads, head dim, page
# size; the serve phase's engine has 8 slots and max_len 512 = 32 pages.
H, KV, HD, PS = 32, 4, 128, 16
B, NPAGES = 8, 32
T_VERIFY, C_PREFILL = 5, 32
SERVE_MAX_LEN = NPAGES * PS
# |kernel - plain| bound, compared in f32: bf16 outputs may differ by one
# bf16 ulp (2^-7 relative) after different f32 summation orders.
TOL_BF16 = 2e-2
# Depth-2 float32 model: logits of kernels vs CPU plain versions.
TOL_PARITY = 1e-3

# Zamba2-1.2B serving shapes (configs/zamba2_1_2b.py): the static engine
# pads 8 prompts to 256 tokens; 32 heads of 64 (G = 1) in the shared
# attention block, 64 SSM heads of 64 with state 64, d_model 2048, d_inner
# 4096, SSD chunk 128.
ZB, ZS, ZH, ZHD = 8, 256, 32, 64
Z_SSM_H, Z_P, Z_N, Z_CHUNK, Z_D, Z_DIN = 64, 64, 64, 128, 2048, 4096
# Dense kernels against their plain versions, compared in f32 on outputs of
# order 1 (the inputs are scaled for it): bf16 within TOL_BF16 as above,
# f32 within TOL_F32 (the same f32 arithmetic, summed in another order).
TOL_F32 = 1e-4

# HuBERT's encode batch: 8 clips of 1000 frames (20 s of 16 kHz audio at
# 20 ms a frame) of the stubbed 512-d conv features. PaliGemma's: 8 images
# of 256 SigLIP patches (1152-d) before 32 text tokens, then 32 decode
# steps; its engines serve 8 text prompts x 32 new tokens, and a profile
# of the static engine's generate takes PG_PROFILE_NEW of them.
HB_B, HB_S = 8, 1000
PG_B, PG_TEXT, PG_NEW, PG_PROFILE_NEW = 8, 32, 32, 8
# Their training batches: hubert's is the encode batch with HuBERT's
# cluster targets; paligemma's 8 x (256 patches + PG_TRAIN_TEXT tokens) =
# 512 positions, the text one chunk of its logit_chunk 640 (a text length
# the chunk does not divide, e.g. 768, would make chunked_xent fall back to
# full-sequence f32 logits, 8 x 768 x 257,216, ~6.3 GB, and their gradient).
PG_TRAIN_TEXT = 256
# The flash backward at their training shapes: (B, S, H, KV, hd, causal).
FRONTEND_TRAIN_FLASH = (("hubert-xlarge", (HB_B, HB_S, 16, 16, 80, False)),
                        ("paligemma-3b", (PG_B, 256 + PG_TRAIN_TEXT, 8, 1,
                                          256, True)))

REPLACES = {
    "flash_decode_fwd": "src/repro/kernels/decode_attention/kernel.py:96",
    "flash_prefill_fwd": "src/repro/kernels/prefill_attention/kernel.py:95",
    "flash_verify_fwd": "src/repro/kernels/verify_attention/kernel.py:102",
    "rmsnorm_fused": "src/repro/kernels/rmsnorm/kernel.py:27",
    "flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:86",
    "ssd_scan": "src/repro/kernels/mamba_scan/kernel.py:70",
}
SOURCES = {
    "flash_decode_fwd": "src/repro_torch/csrc/paged_attention_sm90.cu",
    "flash_prefill_fwd": "src/repro_torch/csrc/paged_attention_sm90.cu",
    "flash_verify_fwd": "src/repro_torch/csrc/paged_attention_sm90.cu",
    "rmsnorm_fused": "src/repro_torch/csrc/rmsnorm.cu",
    "flash_attention_fwd": "src/repro_torch/csrc/flash_attention.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
    "rmsnorm_bwd": "src/repro_torch/csrc/rmsnorm.cu",
    "flash_attention_bwd": "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
    "ssd_scan_bwd": "src/repro_torch/csrc/ssd_scan_bwd_sm90.cu",
}
PAGED = ("flash_decode_fwd", "flash_prefill_fwd", "flash_verify_fwd")
# The continuous engine's three serve runs: plain decode, speculative decode
# (K = 4) and an int8 pool.
SERVE_RUNS = {"plain": {}, "spec": dict(enable_spec_decode=True,
                                        spec_tokens=4),
              "int8": dict(kv_cache_dtype="int8")}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Device time of one call: the mean over ``iters`` back-to-back calls
    between two CUDA events. A spin kernel (``torch.cuda._sleep``) goes
    first, sized to outlast the host's enqueue of all the timed calls, so
    the start event fires only once they are all queued and the events
    bracket device work, not the host's cost of issuing it (a wrapper's
    checks, allocation and launch, or PyTorch's dispatcher). If the start
    event has already fired when the host finishes enqueuing, the spin was
    too short: it is made 4x longer and the run repeated."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # twice the expected enqueue at <= 2 GHz, and at least ~1 ms
    cycles = int(max(2e6, 2 * iters * enqueue_s * 2e9))
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise AssertionError("time_ms: the spin never outlasted the enqueue")


def enqueue_ms(fn, calls: int = 20) -> float:
    """Host time to enqueue one call: the mean over ``calls`` back-to-back
    calls after a synchronise, the device running behind (the wrapper's
    checks, allocation, tensor-map encoding and launch)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e3


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

# The tensor-core instantiations the serve and training paths launch
# (mangled-name fragments): flash attention at hd 64 (Zamba2) and hd 128
# (the dense and MoE transformers' static prefill and dense admission);
# the paged kernel at hd 128
# over bf16 and int8 pools (yi-6b), whole (prefill, and decode and verify
# at one split) and with split-KV partials (decode and verify at the serve
# shape's 4 splits); the SSD scan (Zamba2); the flash backward's dK/dV and
# dQ kernels at hd 128 (internlm2-1.8b training) and the SSD backward's
# state walks (Zamba2 training); the frontends':
# flash at hd 128 also takes HuBERT's hd 80, forward and backward, and
# PaliGemma's MQA at hd 256 runs flash (forward and backward: its dQ kernel
# at 244 registers a thread, its dK/dV at 239 with two warpgroups a block)
# and the paged kernel over a bf16 pool, whole and split. None may spill.
ON_PATH_SM90 = {
    "flash_sm90_kernelILi64E": "flash bf16 hd 64",
    "flash_sm90_kernelILi128E": "flash bf16 hd 128 (and hd 80)",
    "flash_sm90_kernelILi256E": "flash bf16 hd 256",
    "paged_attn_sm90_kernelILi256ELb0ELb0E": "paged hd 256 bf16 pool",
    "paged_attn_sm90_kernelILi256ELb0ELb1E": "paged split hd 256 bf16 pool",
    "ssd_sm90_kernel": "ssd bf16 N = P = 64",
    "ssd_bwd_walk_sm90_kernel": "ssd bwd state walks bf16",
    "paged_attn_sm90_kernelILi128ELb0ELb0E": "paged hd 128 bf16 pool",
    "paged_attn_sm90_kernelILi128ELb1ELb0E": "paged hd 128 int8 pool",
    "paged_attn_sm90_kernelILi128ELb0ELb1E": "paged split hd 128 bf16 pool",
    "paged_attn_sm90_kernelILi128ELb1ELb1E": "paged split hd 128 int8 pool",
    "flash_bwd_dkdv_sm90_kernelILi128E": "flash bwd dK/dV bf16 hd 128 (and "
                                         "hd 80)",
    "flash_bwd_dq_sm90_kernelILi128E": "flash bwd dQ bf16 hd 128 (and hd 80)",
    "flash_bwd_dkdv_sm90_kernelILi256E": "flash bwd dK/dV bf16 hd 256 (two "
                                         "warpgroups)",
    "flash_bwd_dq_sm90_kernelILi256E": "flash bwd dQ bf16 hd 256"}


# The other backward kernels the training path and its f32 parity launch:
# the bf16 flash backward's delta pass (at the tensors' own hd), the f32
# CUDA-core flash backward at hd 128 and 80, RMSNorm's register kernel (D up to 8192 bf16 / 4096 f32) and
# shared-memory kernel (beyond) in both dtypes, the bf16 SSD backward's
# chunk body (wgmma + TMA at 255 registers a thread, whose 12-byte spill is
# reported here rather than failing the build) and sums, and the f32 SSD
# backward's three CUDA-core kernels.
BACKWARD_KERNELS = {
    "flash_bwd_delta_sm90_kernelILi128E": "flash bwd delta bf16 hd 128",
    "flash_bwd_delta_sm90_kernelILi80E": "flash bwd delta bf16 hd 80",
    "flash_bwd_delta_sm90_kernelILi256E": "flash bwd delta bf16 hd 256",
    "flash_bwd_delta_kernel": "flash bwd delta f32",
    "flash_bwd_dkdv_kernelILi128E": "flash bwd dK/dV f32 hd 128",
    "flash_bwd_dq_kernelILi128E": "flash bwd dQ f32 hd 128",
    "flash_bwd_dkdv_kernelILi80E": "flash bwd dK/dV f32 hd 80",
    "flash_bwd_dq_kernelILi80E": "flash bwd dQ f32 hd 80",
    "rmsnorm_bwd_reg_kernelI13__nv_bfloat16Lb1E": "rmsnorm bwd registers bf16",
    "rmsnorm_bwd_reg_kernelIfLb1E": "rmsnorm bwd registers f32",
    "rmsnorm_bwd_kernelI13__nv_bfloat16": "rmsnorm bwd smem bf16",
    "rmsnorm_bwd_kernelIf": "rmsnorm bwd smem f32",
    "ssd_bwd_body_sm90_kernel": "ssd bwd chunk body bf16",
    "ssd_bwd_sums_kernel": "ssd bwd group sums bf16",
    "ssd_bwd_states_kernel": "ssd bwd states f32",
    "ssd_bwd_kernel": "ssd bwd reverse walk f32",
    "ssd_bwd_reduce_kernel": "ssd bwd head sums f32"}


def _ptxas_functions(text):
    """{mangled name: (registers, spill store bytes, spill load bytes)}
    from nvcc's ``-Xptxas -v`` log."""
    import re
    funcs, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
            funcs[name] = (funcs.get(name, (0,))[0],) + spill
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            funcs[name] = (int(m.group(1)),) + funcs.get(name, (0, 0, 0))[1:]
    return funcs


def phase_build():
    import re
    from repro_torch.kernels import _cuda
    t0 = time.perf_counter()
    logs = _cuda.build()
    dt = time.perf_counter() - t0
    seen = {}
    for src, text in logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [ln.strip() for ln in text.splitlines()
                  if "spill" in ln and not ln.strip().endswith(
                      "0 bytes spill stores, 0 bytes spill loads")]
        log(f"[build] {src}: {dt:.1f}s, {len(regs)} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)} a thread, "
            f"{len(spills)} lines with spills")
        for ln in spills[:6]:
            log(f"[build]   {ln}")
        for name, (nreg, st, ld) in _ptxas_functions(text).items():
            for frag, label in ON_PATH_SM90.items():
                if frag in name:
                    seen[label] = (nreg, st, ld)
                    log(f"[build]   {label}: {nreg} registers, spill "
                        f"stores {st} B, loads {ld} B")
    if len(seen) != len(ON_PATH_SM90) \
            or any(st or ld for _, st, ld in seen.values()):
        raise AssertionError(f"on-path sm90 kernels missing or spilling: "
                             f"{seen}")
    # The other backward kernels: listed, a spill reported, not fatal.
    bwd = {name: v for text in logs.values()
           for name, v in _ptxas_functions(text).items()
           if "bwd" in name and not any(f in name for f in ON_PATH_SM90)}
    for frag, label in BACKWARD_KERNELS.items():
        hits = [v for name, v in bwd.items() if frag in name]
        if not hits:
            raise AssertionError(f"backward kernel {label} was not built")
        for nreg, st, ld in hits:
            log(f"[build]   {label}: {nreg} registers, spill stores {st} B, "
                f"loads {ld} B")
    spilled = [name for name, (_, st, ld) in bwd.items() if st or ld]
    log(f"[build]   backward kernels: {len(bwd)} instantiations, "
        f"{len(spilled)} with spills: {spilled}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _pool(gen, kind, num_pages, dev, nkv=KV, ps=PS, hd=HD):
    """A random pool of ``kind``: bf16, int8 with row scales, or f32."""
    import torch
    from repro_torch.kernels import quantize_pool
    shape = (nkv, num_pages, ps, hd)
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    if kind == "int8":
        return quantize_pool({"k": k, "v": v})
    if kind == "f32":
        return {"k": k, "v": v}
    return {"k": k.bfloat16(), "v": v.bfloat16()}


def _page_table(gen, num_pages, dev):
    """Distinct shuffled pages per request, and one out-of-range entry (on a
    page request 0 reads) that the kernel must clamp to P-1."""
    import torch
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
    pt = perm[:B * NPAGES].reshape(B, NPAGES).to(torch.int32)
    pt[0, NPAGES - 1] = num_pages + 5
    return pt.contiguous()


def _bytes_needed(pool, pt, last_pos, q, out):
    """Bytes the function must move: q and page table read, the pages each
    request's visible positions need, and the output written."""
    nkv, _, ps, hd = pool["k"].shape
    pages = ((last_pos.clamp_min(0) // ps) + 1).clamp(max=pt.shape[1])
    n_pages = int(pages.sum())
    row = hd * pool["k"].element_size() + (4 if "k_scale" in pool else 0)
    kv_bytes = 2 * n_pages * nkv * ps * row
    return (kv_bytes + q.numel() * q.element_size()
            + pt.numel() * 4 + out.numel() * out.element_size()
            + last_pos.numel() * 4)


def _flops_needed(q_pos, h=H, hd=HD):
    """QK^T and PV multiply-adds over the keys each query row sees."""
    visible = (q_pos.clamp_min(-1) + 1).sum().item()    # over (B, C)
    return 4.0 * visible * h * hd


def _sdpa_case(q, pool, pt, q_pos):
    """Library yardstick: SDPA over the KV gathered dense (outside the timed
    call), with a boolean mask of what each query row may see."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ref import gather_kv
    k, v = gather_kv(pool["k"], pool["v"], pt, pool.get("k_scale"),
                     pool.get("v_scale"))
    k = k.to(q.dtype).permute(0, 2, 1, 3).contiguous()      # (B,KV,T,hd)
    v = v.to(q.dtype).permute(0, 2, 1, 3).contiguous()
    qq = q.permute(0, 2, 1, 3).contiguous()                  # (B,H,C,hd)
    t = k.shape[2]
    mask = (torch.arange(t, device=q.device)[None, None, :]
            <= q_pos[:, :, None])[:, None]                   # (B,1,C,T)
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def _prefill_edge_cases(gen, kind, dev):
    """bf16 q off the serve shape, on the tensor-core route: C 13 (a ragged
    64-row tile of 16 queries x G 4), H 8 over KV 2, hd 128, page sizes 32
    and 64; q_start 0 and mid-page, and request 0 reading up to the last
    page, whose out-of-range page-table entry must clamp to P-1."""
    import torch
    from repro_torch.kernels import (flash_prefill_fwd,
                                     paged_prefill_reference, quantize_pool)
    b, c, h, nkv, hd = 3, 13, 8, 2, 128
    variants = []
    for ps, npages in ((32, 4), (64, 2)):
        num_pages = b * npages + 1
        k = torch.randn(nkv, num_pages, ps, hd, generator=gen, device=dev)
        v = torch.randn(nkv, num_pages, ps, hd, generator=gen, device=dev)
        pool = (quantize_pool({"k": k, "v": v}) if kind == "int8"
                else {"k": k.bfloat16(), "v": v.bfloat16()})
        scales = dict(k_scale=pool.get("k_scale"),
                      v_scale=pool.get("v_scale"))
        pt = (torch.randperm(num_pages - 1, generator=gen, device=dev)
              + 1).reshape(b, npages).to(torch.int32)
        pt[0, npages - 1] = num_pages + 5
        q = torch.randn(b, c, h, hd, generator=gen, device=dev).bfloat16()
        for start in (0, ps // 2 + 3):
            qs = torch.full((b,), start, dtype=torch.int32, device=dev)
            qs[0] = npages * ps - c
            variants.append((
                lambda q=q, pool=pool, pt=pt, qs=qs, scales=scales:
                flash_prefill_fwd(q, pool["k"], pool["v"], pt, qs, **scales),
                lambda q=q, pool=pool, pt=pt, qs=qs, scales=scales:
                paged_prefill_reference(q, pool["k"], pool["v"], pt, qs,
                                        **scales),
                None, None))
    return variants


# The paged kernels at other models' serve shapes on the tensor-core route,
# with the serve phase's 8 slots, page size 16 and 32 pages a row: (label,
# pool kinds, H, KV, hd, verify, timed). olmoe-1b-7b: H 16 over KV 16 (G
# 1), hd 128, speculative decode on its path; paligemma-3b
# (configs/paligemma_3b.py): H 8 over one KV head (G 8), hd 256, no
# speculative decode on its path, timed.
PAGED_SHAPES = (("olmoe-1b-7b", ("bf16", "int8"), 16, 16, 128, True, False),
                ("paligemma-3b", ("bf16",), 8, 1, 256, False, True))


def _paged_shape_cases(gen, kind, dev, h, nkv, hd, verify):
    """The paged kernels at a model's serve shape (``PAGED_SHAPES``):
    decode at one split (whole) and at the split count the ops layer picks
    (split-KV partials), prefill C 32 at q_start 0 and past it, and verify
    T 5 where ``verify``. Returns (pool, page table, {name: [(kernel,
    plain, q, q_pos)]}), the last variant of each the serve shape."""
    import torch
    from repro_torch.kernels import (default_num_splits, flash_decode_fwd,
                                     flash_prefill_fwd, flash_verify_fwd,
                                     paged_decode_reference,
                                     paged_prefill_reference,
                                     paged_verify_reference)
    num_pages = B * NPAGES + 1
    pool = _pool(gen, kind, num_pages, dev, nkv=nkv, hd=hd)
    scales = dict(k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"))
    pt = _page_table(gen, num_pages, dev)
    span = NPAGES * PS
    splits = default_num_splits(NPAGES, batch=B, split_budget=32)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    def ri(lo, hi):
        return torch.randint(lo, hi, (B,), generator=gen, device=dev,
                             dtype=torch.int32)

    q1, qv, qp = rn(B, h, hd), rn(B, T_VERIFY, h, hd), rn(B, C_PREFILL, h, hd)
    lengths, pos, q_start = (ri(1, span + 1), ri(0, span - T_VERIFY + 1),
                             ri(1, span - C_PREFILL + 1))
    lengths[0] = span                    # reaches the clamped entry
    args = (pool["k"], pool["v"], pt)
    ar_t = torch.arange(T_VERIFY, device=dev)
    ar_c = torch.arange(C_PREFILL, device=dev)
    cases = {
        "flash_decode_fwd": [(
            lambda n=n: flash_decode_fwd(q1, *args, lengths, num_splits=n,
                                         **scales),
            lambda: paged_decode_reference(q1, *args, lengths, **scales),
            q1[:, None], (lengths.long() - 1)[:, None]) for n in (1, splits)],
        "flash_prefill_fwd": [(
            lambda qs=qs: flash_prefill_fwd(qp, *args, qs, **scales),
            lambda qs=qs: paged_prefill_reference(qp, *args, qs, **scales),
            qp, qs.long()[:, None] + ar_c[None])
            for qs in (torch.zeros_like(q_start), q_start)],
    }
    if verify:
        cases["flash_verify_fwd"] = [(
            lambda: flash_verify_fwd(qv, *args, pos, num_splits=splits,
                                     **scales),
            lambda: paged_verify_reference(qv, *args, pos, **scales),
            qv, pos.long()[:, None] + ar_t[None])]
    return pool, pt, cases


def _paged_timing(kern, plain, pool, pt, q, q_pos, got, h=H):
    """A paged call's device time beside its plain version's, SDPA over the
    gathered KV, and the bound."""
    hd = q.shape[-1]
    bytes_s = _bytes_needed(pool, pt, q_pos[:, -1], q, got) / HBM_BYTES_PER_S
    ops_s = _flops_needed(q_pos, h, hd) / BF16_FLOPS_PER_S
    return {"bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "ms": time_ms(kern), "plain_ms": time_ms(plain, iters=5),
            "library_ms": time_ms(_sdpa_case(q, pool, pt, q_pos))}


def _decode_verify_edge_cases(gen, kind, dev):
    """bf16 decode and verify off the serve shape, on the tensor-core route,
    each against its plain version: G 4 (H 8 over KV 2, B 3) at page sizes
    32 and 64, at one split and at the split count the ops layer picks (8
    one-page splits narrower than a 64-key tile, and 4); B 1 at the serve
    heads with 32 one-page splits. Lengths 1, mid-page and the whole table
    (request 0's last page-table entry is out of range and must clamp to
    P-1); verify windows of T 1 to 8 at pos 0, mid-page and the table's
    end. Returns ({name: [(kernel, plain, None, None)]})."""
    import torch
    from repro_torch.kernels import (default_num_splits, flash_decode_fwd,
                                     flash_verify_fwd, paged_decode_reference,
                                     paged_verify_reference)
    out = {"flash_decode_fwd": [], "flash_verify_fwd": []}

    def add(q, pool, pt, base, splits):
        scales = dict(k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"))
        kern, plain, name = (
            (flash_decode_fwd, paged_decode_reference, "flash_decode_fwd")
            if q.dim() == 3 else
            (flash_verify_fwd, paged_verify_reference, "flash_verify_fwd"))
        out[name].append((
            lambda: kern(q, pool["k"], pool["v"], pt, base,
                         num_splits=splits, **scales),
            lambda: plain(q, pool["k"], pool["v"], pt, base, **scales),
            None, None))

    def i32(*xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    for b, h, nkv, ps, npages in ((3, 8, 2, 32, 8), (3, 8, 2, 64, 4),
                                  (1, H, KV, PS, NPAGES)):
        num_pages = b * npages + 1
        pool = _pool(gen, kind, num_pages, dev, nkv=nkv, ps=ps)
        pt = (torch.randperm(num_pages - 1, generator=gen, device=dev)
              + 1).reshape(b, npages).to(torch.int32)
        pt[0, npages - 1] = num_pages + 5
        span, mid = npages * ps, ps + ps // 2 + 3
        chosen = default_num_splits(npages, batch=b, split_budget=32)
        q1 = torch.randn(b, h, HD, generator=gen, device=dev).bfloat16()
        if b == 1:                       # 32 one-page splits
            for length in (1, span - 12, span):
                add(q1, pool, pt, i32(length), chosen)
            for t in range(1, 9):
                qv = torch.randn(1, t, h, HD, generator=gen,
                                 device=dev).bfloat16()
                for p in (0, mid, span - t):
                    add(qv, pool, pt, i32(p), chosen)
            continue
        for splits in (1, chosen):
            add(q1, pool, pt, i32(span, 1, mid), splits)
            for t in (1, 5, 8):
                qv = torch.randn(b, t, h, HD, generator=gen,
                                 device=dev).bfloat16()
                add(qv, pool, pt, i32(span - t, 0, mid), splits)
    return out


def _paged_shapes(gen, dev, results, splits):
    """``PAGED_SHAPES``' cases into ``results[name][kind]``: each against
    its plain version and on the sm90 route, the timed models' serve
    shapes timed under ``transformers``."""
    import torch
    from repro_torch.kernels import (flash_decode_fwd, flash_prefill_fwd,
                                     flash_verify_fwd)
    for label, kinds, h, nkv, hd, verify, timed in PAGED_SHAPES:
        for kind in kinds:
            pool, pt, cases = _paged_shape_cases(gen, kind, dev, h, nkv, hd,
                                                 verify)
            for name, variants in cases.items():
                fn = {"flash_decode_fwd": flash_decode_fwd,
                      "flash_prefill_fwd": flash_prefill_fwd,
                      "flash_verify_fwd": flash_verify_fwd}[name]
                rec, worst = results[name][kind], 0.0
                for vi, (kern, plain, q, q_pos) in enumerate(variants):
                    before = fn.launches_by_route["sm90"]
                    got = kern()
                    torch.cuda.synchronize()
                    err = _max_err(got, plain())
                    ok = (math.isfinite(err) and err <= TOL_BF16
                          and fn.launches_by_route["sm90"] == before + 1)
                    log(f"[kernels] {name} {kind} {label} shape (H {h}, KV "
                        f"{nkv}, hd {hd}) case{vi}: max|kernel-plain| "
                        f"{err:.3e} (tol {TOL_BF16}) {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{name} {kind} at the {label} "
                                             f"shape: error {err}, or it "
                                             f"left the sm90 route")
                    worst = max(err, worst)
                rec["max_abs_err"] = max(worst, rec["max_abs_err"])
                if not timed:
                    continue
                shape = {"B": B, "H": h, "KV": nkv, "hd": hd, "ps": PS,
                         "pages": NPAGES, "C": q.shape[1],
                         "splits": splits if name != "flash_prefill_fwd"
                         else 1, "max_abs_err": worst}
                t = _paged_timing(kern, plain, pool, pt, q, q_pos, got, h)
                rec.setdefault("transformers", {})[label] = {**shape, **t}
                log(f"[kernels] {name} {kind} {label} (G {h // nkv}, hd "
                    f"{hd}): kernel {t['ms']:.4f} ms, plain "
                    f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms,"
                    f" bound {t['bound_ms']:.4f} ms ({t['bound_by']})")


def phase_kernels():
    """The paged kernels against their plain versions: bf16 q over bf16
    and int8 pools on the tensor-core route (edge cases first, then the
    yi-6b serve shape, timed), and over an f32 pool at the serve shape on
    the CUDA-core route (f32, the enqueue timed)."""
    import torch
    from repro_torch.kernels import (default_num_splits, flash_decode_fwd,
                                     flash_prefill_fwd, flash_verify_fwd,
                                     paged_decode_reference,
                                     paged_prefill_reference,
                                     paged_verify_reference)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    num_pages = B * NPAGES + 1
    splits = default_num_splits(NPAGES, batch=B, split_budget=32)
    if splits < 2:
        raise AssertionError(f"decode must split at these shapes: {splits}")
    max_pos = NPAGES * PS
    results, serve_calls = {}, {}
    for kind in ("bf16", "int8", "f32"):
        qdt = torch.float32 if kind == "f32" else torch.bfloat16
        tol = TOL_F32 if kind == "f32" else TOL_BF16
        pool = _pool(gen, kind, num_pages, dev)
        scales = dict(k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"))
        pt = _page_table(gen, num_pages, dev)
        lengths = torch.randint(1, max_pos + 1, (B,), generator=gen,
                                device=dev, dtype=torch.int32)
        lengths[0] = max_pos                 # reaches the clamped entry
        pos = torch.randint(0, max_pos - T_VERIFY + 1, (B,), generator=gen,
                            device=dev, dtype=torch.int32)
        pos[0] = max_pos - T_VERIFY
        q_start = torch.randint(1, max_pos - C_PREFILL + 1, (B,),
                                generator=gen, device=dev, dtype=torch.int32)
        q_start[0] = max_pos - C_PREFILL
        q1 = torch.randn(B, H, HD, generator=gen, device=dev).to(qdt)
        qv = torch.randn(B, T_VERIFY, H, HD, generator=gen,
                         device=dev).to(qdt)
        qp = torch.randn(B, C_PREFILL, H, HD, generator=gen,
                         device=dev).to(qdt)
        ar_t = torch.arange(T_VERIFY, device=dev)
        ar_c = torch.arange(C_PREFILL, device=dev)
        cases = {
            "flash_decode_fwd": [(
                lambda: flash_decode_fwd(q1, pool["k"], pool["v"], pt,
                                         lengths, num_splits=splits,
                                         **scales),
                lambda: paged_decode_reference(q1, pool["k"], pool["v"], pt,
                                               lengths, **scales),
                q1[:, None], (lengths.long() - 1)[:, None])],
            "flash_verify_fwd": [(
                lambda: flash_verify_fwd(qv, pool["k"], pool["v"], pt, pos,
                                         num_splits=splits, **scales),
                lambda: paged_verify_reference(qv, pool["k"], pool["v"], pt,
                                               pos, **scales),
                qv, pos.long()[:, None] + ar_t[None])],
            "flash_prefill_fwd": [(
                lambda qs=qs: flash_prefill_fwd(qp, pool["k"], pool["v"], pt,
                                                qs, **scales),
                lambda qs=qs: paged_prefill_reference(qp, pool["k"],
                                                      pool["v"], pt, qs,
                                                      **scales),
                qp, qs.long()[:, None] + ar_c[None])
                for qs in (torch.zeros_like(q_start), q_start)],
        }
        if kind != "f32":
            cases["flash_prefill_fwd"][:0] = _prefill_edge_cases(gen, kind,
                                                                 dev)
            for name, extra in _decode_verify_edge_cases(gen, kind,
                                                         dev).items():
                cases[name][:0] = extra
        for name, variants in cases.items():
            for vi, (kern, plain, q, q_pos) in enumerate(variants):
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                err = (got.float() - want.float()).abs().max().item()
                ok = math.isfinite(err) and err <= tol
                log(f"[kernels] {name} {kind} case{vi}: max|kernel-plain| "
                    f"{err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} {kind} disagrees: {err}")
                rec = results.setdefault(name, {}).setdefault(kind, {})
                rec["max_abs_err"] = max(err, rec.get("max_abs_err", 0.0))
                if vi != len(variants) - 1:
                    continue
                # the serve shape (prefill: at q_start > 0), which comes
                # after every edge case: the device time on the tensor-core
                # route; the enqueue of every kind, below
                serve_calls.setdefault(name, {})[kind] = kern
                if kind == "f32":
                    continue
                rec.update(_paged_timing(kern, plain, pool, pt, q, q_pos,
                                         got))
                log(f"[kernels] {name} {kind}: kernel {rec['ms']:.4f} ms, "
                    f"plain {rec['plain_ms']:.4f} ms, sdpa "
                    f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f}"
                    f" ms ({rec['bound_by']})")
    _paged_shapes(gen, dev, results, splits)
    # The host's enqueue of each kind's serve-shape call (bf16 and int8
    # pools: the sm90 route; f32: cuda_core), the kinds in turns so that
    # drift on the host falls on all of them; the median of 10 each.
    for name in PAGED:
        runs = {kind: [] for kind in serve_calls[name]}
        for _ in range(5):
            for kind in ("f32", "bf16", "int8", "int8", "bf16", "f32"):
                runs[kind].append(enqueue_ms(serve_calls[name][kind]))
        for kind, times in runs.items():
            results[name][kind]["enqueue_ms"] = statistics.median(times)
        med = {k: results[name][k]["enqueue_ms"] for k in runs}
        log(f"[kernels] {name} enqueue (median of 10, in turns): sm90 bf16 "
            f"{med['bf16']:.4f} ms, int8 {med['int8']:.4f} ms; cuda_core f32 "
            f"{med['f32']:.4f} ms ({med['bf16'] / med['f32']:.2f}x)")
    return results


def _dense_inputs(gen, dtype, dev):
    """Zamba2 serve-shape inputs, scaled so outputs are of order 1: the
    RMSNorm rows and weights, the shared block's q/k/v, and the SSD scan's
    x, dt (softplus of a normal, as the model makes it), a_log and B/C."""
    import torch
    import torch.nn.functional as F

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    ssd = (rn(ZB, ZS, Z_SSM_H, Z_P).to(dtype),
           F.softplus(rn(ZB, ZS, Z_SSM_H)),
           0.5 * rn(Z_SSM_H),
           (rn(ZB, ZS, Z_N) * Z_N ** -0.5).to(dtype),
           (rn(ZB, ZS, Z_N) * Z_N ** -0.5).to(dtype))
    return {
        "rmsnorm": (rn(ZB * ZS, Z_D).to(dtype), 0.25 + 0.05 * rn(Z_D)),
        "rmsnorm_gate": (rn(ZB * ZS, Z_DIN).to(dtype),
                         0.25 + 0.05 * rn(Z_DIN)),
        "flash": tuple(rn(ZB, ZS, ZH, ZHD).to(dtype) for _ in range(3)),
        "ssd": ssd,
    }


def _dense_edge_cases(gen, dev):
    """Shapes off the serve path, f32: a ragged row width, a ragged causal
    and non-causal GQA attention (G = 4, hd 128), a three-chunk SSD scan
    with a chunk, N and P that are not the serve path's, and the SSD scan's
    ragged last chunks of ``SSD_RAGGED`` at the Zamba2 widths."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x, w = rn(3, 1000), rn(1000)
    q, k, v = rn(2, 77, 8, 128), rn(2, 77, 2, 128), rn(2, 77, 2, 128)
    sx, sdt, sa = rn(2, 96, 4, 32), F.softplus(rn(2, 96, 4)), 0.5 * rn(4)
    sb, sc = rn(2, 96, 16) * 0.25, rn(2, 96, 16) * 0.25
    return {
        "rmsnorm_fused": [(lambda: K.rmsnorm_fused(x, w),
                           lambda: K.rmsnorm_reference(x, w))],
        "flash_attention_fwd": [
            (lambda c=c: K.flash_attention_fwd(q, k, v, causal=c),
             lambda c=c: K.attention_reference(q, k, v, causal=c))
            for c in (True, False)],
        "ssd_scan": [(lambda: K.ssd_scan(sx, sdt, sa, sb, sc, chunk=32),
                      lambda: K.ssd_chunked_reference(sx, sdt, sa, sb, sc,
                                                      chunk=32))] + [
            _ssd_case(gen, dev, torch.float32, 2, s, chunk)
            for s, chunk in SSD_RAGGED],
    }


def _flash_bf16_edge_cases(gen, dev):
    """bf16 flash attention off the serve shape, on the tensor-core route:
    Sq = Skv = 77 (ragged 64-row tiles) with G 4 and hd 128, causal and
    not; and hd 256 (four 64-column sub-tiles) at S 130, G 2."""
    import torch
    from repro_torch import kernels as K

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    q, k, v = rn(2, 77, 8, 128), rn(2, 77, 2, 128), rn(2, 77, 2, 128)
    q2, k2, v2 = rn(1, 130, 4, 256), rn(1, 130, 2, 256), rn(1, 130, 2, 256)
    return [(lambda c=c: K.flash_attention_fwd(q, k, v, causal=c),
             lambda c=c: K.attention_reference(q, k, v, causal=c))
            for c in (True, False)] + [
        (lambda: K.flash_attention_fwd(q2, k2, v2),
         lambda: K.attention_reference(q2, k2, v2))]


def _ssd_case(gen, dev, dtype, b, s, chunk, dt_scale=1.0, h=Z_SSM_H):
    """An SSD scan at the Zamba2 widths (H 64, or ``h`` heads; N = P = 64)
    and its plain version on the same inputs; x / dt_scale keeps the
    outputs of order 1 under a strong decay."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    args = ((rn(b, s, h, Z_P) / dt_scale).to(dtype),
            F.softplus(rn(b, s, h)) * dt_scale, 0.5 * rn(h),
            (rn(b, s, Z_N) * Z_N ** -0.5).to(dtype),
            (rn(b, s, Z_N) * Z_N ** -0.5).to(dtype))
    return (lambda: K.ssd_scan(*args, chunk=chunk),
            lambda: K.ssd_chunked_reference(*args, chunk=chunk))


# (S, chunk) with a ragged last chunk: 2 and 72 rows of 128 (the Zamba2
# engine's chunk at longest prompts of 130 and 200), 8 rows of 16.
SSD_RAGGED = ((130, Z_CHUNK), (200, Z_CHUNK), (40, 16))


def _ssd_bf16_edge_cases(gen, dev):
    """bf16 SSD scans off the serve shape, on the tensor-core route: S 40
    in one chunk of 40 (a ragged tile: rows 40-63 past S), S 384 (three
    chunks of 128), B 1 at S 256 (HB 1: 64 blocks), strong decay (dt x 20,
    so exp(la) underflows within a chunk), and the ragged last chunks of
    ``SSD_RAGGED`` (at S 130 the last chunk's second 64-row box lies wholly
    past S)."""
    import torch
    bf = torch.bfloat16
    return [_ssd_case(gen, dev, bf, 2, 40, 40),
            _ssd_case(gen, dev, bf, 2, 384, Z_CHUNK),
            _ssd_case(gen, dev, bf, 1, ZS, Z_CHUNK),
            _ssd_case(gen, dev, bf, 2, ZS, Z_CHUNK, dt_scale=20.0)] + [
        _ssd_case(gen, dev, bf, 2, s, chunk) for s, chunk in SSD_RAGGED]


def _rmsnorm_decode_cases(gen, dev):
    """bf16 RMSNorm at decode's row counts, 1 and 8, over a width that
    fills 16-byte vectors (1000), a ragged one (4097: scalar loads) and
    the largest (32768: the shared-memory kernel)."""
    import torch
    from repro_torch import kernels as K
    cases = []
    for d in (1000, 4097, 32768):
        w = 0.25 + 0.05 * torch.randn(d, generator=gen, device=dev)
        for rows in (1, 8):
            x = torch.randn(rows, d, generator=gen, device=dev).bfloat16()
            cases.append((lambda x=x, w=w: K.rmsnorm_fused(x, w),
                          lambda x=x, w=w: K.rmsnorm_reference(x, w)))
    return cases


def _rmsnorm_decode_rows(gen, dev):
    """RMSNorm at decode's 8 rows (yi-6b's 4096, Zamba2's 2048 and 4096)
    and at Zamba2's prefill 2048 rows on both kernels: device ms beside
    ``F.rms_norm`` and the byte bound (x read once, out written once, w
    read once)."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K
    from repro_torch.kernels import _cuda
    out = {}
    for rows, d in ((8, 4096), (8, 2048), (ZB * ZS, Z_D)):
        x = torch.randn(rows, d, generator=gen, device=dev).bfloat16()
        w = 0.25 + 0.05 * torch.randn(d, generator=gen, device=dev)
        wb = w.bfloat16()
        err = _max_err(K.rmsnorm_fused(x, w), K.rmsnorm_reference(x, w))
        if not err <= TOL_BF16:
            raise AssertionError(f"rmsnorm {rows}x{d} disagrees: {err}")
        rec = {"max_abs_err": err,
               "bound_ms": (2 * rows * d * 2 + 4 * d) / HBM_BYTES_PER_S * 1e3,
               "ms": time_ms(lambda: K.rmsnorm_fused(x, w)),
               "library_ms": time_ms(lambda: F.rms_norm(x, (d,), wb, 1e-6))}
        if rows > 8:
            # the shared-memory kernel at the prefill's rows, for the
            # choice of kernel by D alone
            y = torch.empty_like(x)
            lib = _cuda.library("rmsnorm.cu")
            rec["smem_ms"] = time_ms(lambda: _cuda.raise_on(
                lib.rmsnorm_smem_fwd(x.data_ptr(), 1, w.data_ptr(),
                                     y.data_ptr(), rows, d, 1e-6,
                                     _cuda.stream_of(x)), "rmsnorm smem"))
        out[f"{rows}x{d}"] = rec
        log(f"[kernels] rmsnorm_fused bf16 {rows}x{d}: kernel "
            f"{rec['ms']:.4f} ms, F.rms_norm {rec['library_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.5f} ms"
            + (f", shared-memory kernel {rec['smem_ms']:.4f} ms"
               if "smem_ms" in rec else ""))
    return out


# The static engine's prefill attention at full width (8 prompts padded to
# ZS): (label, H, KV), hd 128 each; and one dense-admission pad bucket.
FLASH_TRANSFORMERS = (("olmoe-1b-7b", 16, 16), ("mistral-nemo-12b", 32, 8),
                      ("arctic-480b", 56, 8))


def _flash_transformer_shapes(gen, dev):
    """bf16 flash attention at the dense and MoE transformers' shapes on
    the tensor-core route, held against the plain version and timed beside
    causal SDPA and the bound: B 8, S 256 at G 1, 4 and 7 (hd 128),
    mistral-nemo-12b's dense-admission bucket of 2 prompts padded to 96,
    and internlm2-1.8b's training shape (B 8, S 1024, H 16, KV 8), where
    the training step's call also writes the rows' log-sum-exp (timed
    both ways; the bound counts the lse write where it is made)."""
    import torch
    from repro_torch import kernels as K
    out = {}
    shapes = [(label, ZB, ZS, h, nkv) for label, h, nkv in FLASH_TRANSFORMERS]
    shapes.append(("mistral-nemo-12b bucket", 2, 96, 32, 8))
    shapes.append(("internlm2-1.8b train", TB, TS, TH, TKV))
    for label, b, s, h, nkv in shapes:
        q = torch.randn(b, s, h, 128, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(b, s, nkv, 128, generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        err = _max_err(K.flash_attention_fwd(q, k, v),
                       K.attention_reference(q, k, v))
        if not (math.isfinite(err) and err <= TOL_BF16):
            raise AssertionError(f"flash {label} disagrees: {err}")
        pairs = b * h * s * (s + 1) // 2
        nbytes = (2 * b * s * h + 2 * b * s * nkv) * 128 * 2
        ops_s = 4.0 * 128 * pairs / BF16_FLOPS_PER_S
        bound_s = max(nbytes / HBM_BYTES_PER_S, ops_s)
        rec = {"shape": [b, s, h, nkv, 128], "max_abs_err": err,
               "bound_ms": bound_s * 1e3,
               "ms": time_ms(lambda: K.flash_attention_fwd(q, k, v)),
               "library_ms": time_ms(_sdpa_dense(q, k, v))}
        lse = ""
        if label.endswith("train"):
            rec["lse_ms"] = time_ms(lambda: K.flash_attention_fwd(
                q, k, v, return_lse=True))
            rec["lse_bound_ms"] = max(
                (nbytes + 4 * b * h * s) / HBM_BYTES_PER_S, ops_s) * 1e3
            rec["bound_by"] = ("operations" if ops_s > nbytes / HBM_BYTES_PER_S
                               else "bytes")
            lse = (f", with lse (the training call) {rec['lse_ms']:.4f} ms "
                   f"(bound {rec['lse_bound_ms']:.4f} ms), bound by "
                   f"{rec['bound_by']}")
        out[label] = rec
        log(f"[kernels] flash_attention_fwd bf16 {label} (B {b}, S {s}, H "
            f"{h}, KV {nkv}, hd 128): max|kernel-plain| {err:.3e}, kernel "
            f"{rec['ms']:.4f} ms, sdpa {rec['library_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms{lse}")
    return out


def _rmsnorm_transformer_widths(gen, dev):
    """bf16 RMSNorm at the new widths (mistral-nemo-12b's 5120, Arctic's
    7168) over the static prefill's 2048 rows and decode's 8, and at the
    frontends' (hubert-xlarge's encode, HB_B x HB_S rows at 1280;
    paligemma-3b's patch prefill, PG_B x (256 + PG_TEXT) rows at 2048),
    with f32 weights as the models have; each one launch on the register
    kernel, held against the plain version and timed beside
    ``F.rms_norm`` and the byte bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_path
    out = {}
    for rows, d in ((ZB * ZS, 5120), (ZB * ZS, 7168), (8, 5120), (8, 7168),
                    (HB_B * HB_S, 1280), (PG_B * (256 + PG_TEXT), 2048)):
        if rmsnorm_path(d, torch.bfloat16) != "registers":
            raise AssertionError(f"rmsnorm at D {d} leaves the register "
                                 f"kernel")
        x = torch.randn(rows, d, generator=gen, device=dev).bfloat16()
        w = 0.25 + 0.05 * torch.randn(d, generator=gen, device=dev)
        wb = w.bfloat16()
        before = K.rmsnorm_fused.launches
        got = K.rmsnorm_fused(x, w)
        launched = K.rmsnorm_fused.launches - before
        err = _max_err(got, K.rmsnorm_reference(x, w))
        if launched != 1 or not (math.isfinite(err) and err <= TOL_BF16):
            raise AssertionError(f"rmsnorm {rows}x{d}: error {err}, "
                                 f"launches {launched}")
        rec = {"max_abs_err": err,
               "bound_ms": (2 * rows * d * 2 + 4 * d) / HBM_BYTES_PER_S * 1e3,
               "ms": time_ms(lambda: K.rmsnorm_fused(x, w)),
               "library_ms": time_ms(lambda: F.rms_norm(x, (d,), wb, 1e-6))}
        out[f"{rows}x{d}"] = rec
        log(f"[kernels] rmsnorm_fused bf16 {rows}x{d} (register kernel): "
            f"max|kernel-plain| {err:.3e} (tol {TOL_BF16}), kernel "
            f"{rec['ms']:.4f} ms, F.rms_norm {rec['library_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.5f} ms")
    return out


# The frontends' dense attention (configs/hubert_xlarge.py,
# configs/paligemma_3b.py): (label, B, S, H, KV, hd, causal). HuBERT's
# encoder over 8 clips of 1000 frames (20 s of 16 kHz audio at 20 ms a
# frame), hd 80, not causal; PaliGemma's prefill of 256 image patches and
# 32 text tokens, H 8 over one KV head, hd 256, causal.
FRONTEND_FLASH = (("hubert-xlarge", 8, 1000, 16, 16, 80, False),
                  ("paligemma-3b prefill", 8, 288, 8, 1, 256, True))


def _flash_hd80_edge_cases(gen, dev):
    """Flash at hd 80 off hubert's shape, bf16 (the hd-128 kernel over
    zero-filled columns) and f32: S 77 (a ragged 64-row tile), H 8 over KV
    2, causal and full; the output against the plain version (TOL_BF16,
    TOL_F32) and the row log-sum-exp (``return_lse``, what training reads)
    against ``attention_lse_reference`` within TOL_F32 in both dtypes: the
    scores are f32 sums of the same products, and the padded columns must
    not move them. A bf16 call at hd 96, outside the contract, must raise
    before any launch. Returns the largest output error."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels.flash_attention.ref import attention_lse_reference
    worst = 0.0
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        q = torch.randn(2, 77, 8, 80, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(2, 77, 2, 80, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        for causal in (True, False):
            got, lse = K.flash_attention_fwd(q, k, v, causal=causal,
                                             return_lse=True)
            err = _max_err(got, K.attention_reference(q, k, v, causal=causal))
            lerr = _max_err(lse, attention_lse_reference(q, k, v,
                                                         causal=causal))
            log(f"[kernels] flash_attention_fwd {dtype} hd 80 S 77 G 4 "
                f"{'causal' if causal else 'full'}: max|kernel-plain| "
                f"{err:.3e} (tol {tol}), lse {lerr:.3e} (tol {TOL_F32})")
            if not (err <= tol and lerr <= TOL_F32):
                raise AssertionError(f"flash hd 80 {dtype} causal={causal}: "
                                     f"out {err}, lse {lerr}")
            worst = max(worst, err)
    before = K.flash_attention_fwd.launches
    q96 = torch.zeros(1, 8, 2, 96, device=dev, dtype=torch.bfloat16)
    try:
        K.flash_attention_fwd(q96, q96, q96)
    except ValueError as e:
        if "80" not in str(e) or K.flash_attention_fwd.launches != before:
            raise AssertionError(f"bf16 flash at hd 96: {e}") from None
    else:
        raise AssertionError("bf16 flash at hd 96 did not raise")
    return {"max_abs_err": worst}


def _flash_frontend_shapes(gen, dev):
    """Flash attention at ``FRONTEND_FLASH``: bf16 on the tensor-core route
    (hd 80 through the hd-128 kernel over zero-filled columns) and, at hd
    80, f32 on the CUDA-core route, each held against the plain version
    (TOL_BF16, TOL_F32) and timed beside it, SDPA at the true hd and the
    bound. The bound counts the true hd: the padded columns are the
    kernel's cost, not the function's."""
    import torch
    from repro_torch import kernels as K
    out = {"hd 80 edge cases": _flash_hd80_edge_cases(gen, dev)}
    for label, b, s, h, nkv, hd, causal in FRONTEND_FLASH:
        kinds = ((torch.bfloat16, TOL_BF16, "sm90", BF16_FLOPS_PER_S),)
        if hd == 80:
            kinds += ((torch.float32, TOL_F32, "cuda_core", F32_FLOPS_PER_S),)
        for dtype, tol, route, peak in kinds:
            q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(b, s, nkv, hd, generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            before = dict(K.flash_attention_fwd.launches_by_route)

            def kern():
                return K.flash_attention_fwd(q, k, v, causal=causal)

            def plain():
                return K.attention_reference(q, k, v, causal=causal)

            got = kern()
            torch.cuda.synchronize()
            took = {r: n - before[r] for r, n in
                    K.flash_attention_fwd.launches_by_route.items()}
            if took[route] != 1 or sum(took.values()) != 1:
                raise AssertionError(f"flash {label} {dtype} launched on "
                                     f"{took}, expected {route}")
            err = _max_err(got, plain())
            tag = f"{label} {'bf16' if route == 'sm90' else 'f32'}"
            if not (math.isfinite(err) and err <= tol):
                raise AssertionError(f"flash {tag} disagrees: {err}")
            pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
            nbytes = (2 * b * s * h + 2 * b * s * nkv) * hd * q.element_size()
            bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, 4.0 * hd * pairs / peak
            qq, kk, vv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            gqa = {"enable_gqa": True} if h != nkv else {}
            rec = {"shape": [b, s, h, nkv, hd], "causal": causal,
                   "route": route, "max_abs_err": err,
                   "bound_ms": max(bytes_s, ops_s) * 1e3,
                   "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                   "ms": time_ms(kern), "plain_ms": time_ms(plain, iters=3),
                   "library_ms": time_ms(
                       lambda: torch.nn.functional.scaled_dot_product_attention(
                           qq, kk, vv, is_causal=causal, **gqa))}
            out[tag] = rec
            log(f"[kernels] flash_attention_fwd {tag} (B {b}, S {s}, H {h}, "
                f"KV {nkv}, hd {hd}, {'causal' if causal else 'full'}): "
                f"max|kernel-plain| {err:.3e} (tol {tol}), kernel "
                f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, sdpa "
                f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']})")
    return out


def _max_err(got, want) -> float:
    if isinstance(got, tuple):                    # SSD: y and the final state
        return max(_max_err(g, w) for g, w in zip(got, want))
    return (got.float() - want.float()).abs().max().item()


def _dense_bounds(inp, dtype_bytes: int):
    """(bytes, flops) each kernel must move and do at the serve shapes:
    every input read once, every output written once; flops the visible
    work (causal pairs, the SSD's lower-triangular terms)."""
    rows, d = inp["rmsnorm"][0].shape
    rms = (2 * rows * d * dtype_bytes + 4 * d, 4.0 * rows * d)
    pairs = ZB * ZH * ZS * (ZS + 1) // 2
    flash = (4 * ZB * ZS * ZH * ZHD * dtype_bytes, 4.0 * ZHD * pairs)
    tri, nc = Z_CHUNK * (Z_CHUNK + 1) // 2, ZS // Z_CHUNK
    per_chunk = 2.0 * (tri * Z_N + tri * Z_P + 2 * Z_CHUNK * Z_N * Z_P)
    ssd_bytes = (2 * ZB * ZS * Z_SSM_H * Z_P * dtype_bytes
                 + 4 * ZB * ZS * Z_SSM_H + 4 * Z_SSM_H
                 + 2 * ZB * ZS * Z_N * dtype_bytes
                 + 4 * ZB * Z_SSM_H * Z_N * Z_P)
    ssd = (ssd_bytes, per_chunk * nc * ZB * Z_SSM_H)
    return {"rmsnorm_fused": rms, "flash_attention_fwd": flash,
            "ssd_scan": ssd}


def phase_dense_kernels():
    """RMSNorm, flash attention and the SSD scan against their plain
    versions at the Zamba2 serve shapes, bf16 (timed) then f32, every SSD
    call on its dtype's route; RMSNorm at decode's rows, timed."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    results = {}
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        inp = _dense_inputs(gen, dtype, dev)
        x, w = inp["rmsnorm"]
        xg, wg = inp["rmsnorm_gate"]
        q, k, v = inp["flash"]
        cases = {
            "rmsnorm_fused": [(lambda: K.rmsnorm_fused(x, w),
                               lambda: K.rmsnorm_reference(x, w)),
                              (lambda: K.rmsnorm_fused(xg, wg),
                               lambda: K.rmsnorm_reference(xg, wg))],
            "flash_attention_fwd": [(lambda: K.flash_attention_fwd(q, k, v),
                                     lambda: K.attention_reference(q, k, v))],
            "ssd_scan": [(lambda: K.ssd_scan(*inp["ssd"], chunk=Z_CHUNK),
                          lambda: K.ssd_chunked_reference(*inp["ssd"],
                                                          chunk=Z_CHUNK))],
        }
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        if kind == "f32":
            for name, extra in _dense_edge_cases(gen, dev).items():
                cases[name] += extra
        else:
            cases["flash_attention_fwd"] += _flash_bf16_edge_cases(gen, dev)
            cases["ssd_scan"] += _ssd_bf16_edge_cases(gen, dev)
            cases["rmsnorm_fused"] += _rmsnorm_decode_cases(gen, dev)
        K.reset_launch_counts()
        for name, variants in cases.items():
            rec = results.setdefault(name, {}).setdefault(kind, {})
            for vi, (kern, plain) in enumerate(variants):
                got = kern()
                torch.cuda.synchronize()
                err = _max_err(got, plain())
                ok = math.isfinite(err) and err <= tol
                log(f"[kernels] {name} {kind} case{vi}: max|kernel-plain| "
                    f"{err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} {kind} disagrees: {err}")
                rec["max_abs_err"] = max(err, rec.get("max_abs_err", 0.0))
        n_ssd = len(cases["ssd_scan"])
        want = ({"sm90": n_ssd, "cuda_core": 0} if kind == "bf16"
                else {"sm90": 0, "cuda_core": n_ssd})
        if K.launch_counts_by_route()["ssd_scan"] != want:
            raise AssertionError(f"{kind} ssd_scan routes "
                                 f"{K.launch_counts_by_route()['ssd_scan']},"
                                 f" expected {want}")
        if kind != "bf16":
            continue
        wx = w.to(x.dtype)             # cast outside: one call timed
        lib = {
            "rmsnorm_fused": lambda: F.rms_norm(x, (Z_D,), wx, 1e-6),
            "flash_attention_fwd": _sdpa_dense(q, k, v),
            "ssd_scan": None,          # no single PyTorch call computes it
        }
        for name, (nbytes, flops) in _dense_bounds(inp, 2).items():
            rec = results[name][kind]
            kern, plain = cases[name][0]
            bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
            rec["bound_ms"] = max(bytes_s, ops_s) * 1e3
            rec["bound_by"] = "bytes" if bytes_s >= ops_s else "operations"
            rec["ms"] = time_ms(kern)
            rec["plain_ms"] = time_ms(plain, iters=5)
            rec["library_ms"] = (time_ms(lib[name]) if lib[name] is not None
                                 else None)
            libtxt = (f"{rec['library_ms']:.4f} ms" if lib[name] is not None
                      else "none")
            log(f"[kernels] {name} bf16: kernel {rec['ms']:.4f} ms, plain "
                f"{rec['plain_ms']:.4f} ms, library {libtxt}, bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        for name, fn in (("flash_attention_fwd", _flash_transformer_shapes),
                         ("rmsnorm_fused", _rmsnorm_transformer_widths)):
            rec = results[name][kind]
            rec["transformers"] = fn(gen, dev)
            if name == "flash_attention_fwd":
                rec["transformers"].update(_flash_frontend_shapes(gen, dev))
            rec["max_abs_err"] = max([rec["max_abs_err"]] + [
                r["max_abs_err"] for r in rec["transformers"].values()])
        results["rmsnorm_fused"][kind]["rows"] = _rmsnorm_decode_rows(gen,
                                                                      dev)
    return results


def _sdpa_dense(q, k, v):
    """Library yardstick: causal SDPA on (B,H,S,hd) copies made outside the
    timed call."""
    import torch.nn.functional as F
    qq, kk, vv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    gqa = {"enable_gqa": True} if q.shape[2] != k.shape[2] else {}
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                                  **gqa)


# ---------------------------------------------------------------------------
# phase 4: depth-2 model parity, card (kernels) vs CPU (plain versions)
# ---------------------------------------------------------------------------

def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _paged_parity(cfg, label):
    """Paged prefill (four requests of one chunk), three decode steps and a
    verify window of T_VERIFY, f32, on the card (kernels) against the same
    weights on the CPU (plain versions), every paged launch on the
    CUDA-core route."""
    import numpy as np
    import torch
    from repro_torch.kernels import (launch_counts, launch_counts_by_route,
                                     reset_launch_counts)
    from repro_torch.models import get_family, init_params
    from repro_torch.train import (build_paged_decode_step,
                                   build_paged_prefill_step,
                                   build_paged_verify_step)
    fam = get_family(cfg)
    gpu = init_params(cfg, fam.layout(cfg), seed=0, device="cuda")
    cpu = _to(gpu, "cpu")
    nb, npages = 4, 8
    num_pages = 1 + nb * npages
    pools = {d: fam.paged_pool(cfg, num_pages, "f32", device=d)
             for d in ("cuda", "cpu")}
    rng = np.random.RandomState(0)
    plen = np.array([20, 32, 7, 29], np.int32)
    toks = np.zeros((nb, C_PREFILL), np.int32)
    for i, n in enumerate(plen):
        toks[i, :n] = rng.randint(0, cfg.vocab_size, size=n)
    pt = np.arange(1, num_pages, dtype=np.int32).reshape(nb, npages)
    steps = {"prefill": build_paged_prefill_step(cfg),
             "decode": build_paged_decode_step(cfg),
             "verify": build_paged_verify_step(cfg)}
    worst = {}
    reset_launch_counts()

    def run(kind, batch):
        outs = {}
        for d in ("cuda", "cpu"):
            b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
            nxt, logits, pools[d] = steps[kind]({"cuda": gpu, "cpu": cpu}[d],
                                                b, pools[d])
            outs[d] = (nxt.cpu().numpy(), logits.float().cpu())
        err = (outs["cuda"][1] - outs["cpu"][1]).abs().max().item()
        worst[kind] = max(err, worst.get(kind, 0.0))
        if not math.isfinite(err) or err > TOL_PARITY:
            raise AssertionError(f"parity {label} {kind}: max|logit diff| "
                                 f"{err}")
        return outs["cpu"][0]

    first = run("prefill", {"tokens": toks,
                            "q_start": np.zeros(nb, np.int32),
                            "kv_len": plen, "page_table": pt,
                            "logit_idx": plen - 1})
    cur, pos = first, plen.copy()
    for _ in range(3):
        cur = run("decode", {"tokens": cur[:, None], "pos": pos,
                             "page_table": pt})
        pos = pos + 1
    window = np.stack([cur] + [(cur + i) % cfg.vocab_size
                               for i in range(1, T_VERIFY)], axis=1)
    run("verify", {"tokens": window.astype(np.int32), "pos": pos,
                   "page_table": pt,
                   "write_limit": (pos + T_VERIFY).astype(np.int32)})
    counts = launch_counts()
    if min(counts[k] for k in PAGED + ("rmsnorm_fused",)) < cfg.num_layers:
        raise AssertionError(f"parity {label} missed a kernel: {counts}")
    for name in PAGED:
        routes = launch_counts_by_route()[name]
        if routes != {"sm90": 0, "cuda_core": counts[name]}:
            raise AssertionError(f"f32 {name} left the CUDA-core route: "
                                 f"{routes}")
    for kind, err in worst.items():
        log(f"[parity] {label} widths, {cfg.num_layers} layers, f32: {kind} "
            f"max|logit card-cpu| {err:.3e} (tol {TOL_PARITY})")
    del gpu, pools
    torch.cuda.empty_cache()


def _static_parity(cfg, seqs, label,
                   kernels=("rmsnorm_fused", "flash_attention_fwd")):
    """The static engine's steps, f32, batch 2: a prefill of each length in
    ``seqs`` and four decode steps over the cache grown by 8 rows, on the
    card against the CPU; logits and every cache leaf within TOL_PARITY,
    each of ``kernels`` launched, every flash launch on the CUDA-core
    route."""
    import numpy as np
    import torch
    from repro_torch.kernels import (launch_counts, launch_counts_by_route,
                                     reset_launch_counts)
    from repro_torch.models import get_family, init_params
    from repro_torch.train import build_decode_step, build_prefill_step
    fam = get_family(cfg)
    gpu = init_params(cfg, fam.layout(cfg), seed=0, device="cuda")
    params = {"cuda": gpu, "cpu": _to(gpu, "cpu")}
    prefill, decode = build_prefill_step(cfg), build_decode_step(cfg)
    rng = np.random.RandomState(0)
    reset_launch_counts()
    worst = {}

    def check(kind, got, want):
        err = (got.float().cpu() - want.float()).abs().max().item()
        worst[kind] = max(err, worst.get(kind, 0.0))
        if not math.isfinite(err) or err > TOL_PARITY:
            raise AssertionError(f"{label} parity {kind}: max|diff| {err}")

    for seq in seqs:
        toks = rng.randint(0, cfg.vocab_size, size=(2, seq)).astype(np.int64)
        caches, logits = {}, {}
        for d in ("cuda", "cpu"):
            logits[d], cache = prefill(params[d],
                                       {"tokens": torch.from_numpy(toks).to(d)})
            for name in fam.grown_cache_leaves:        # room for the decodes
                cache[name] = torch.nn.functional.pad(cache[name],
                                                      (0, 0, 0, 0, 0, 8))
            caches[d] = cache
        check(f"S {seq} prefill logits", logits["cuda"], logits["cpu"])
        cur = logits["cpu"].argmax(-1)
        for step in range(4):
            pos = torch.full((2,), seq + step, dtype=torch.int32)
            for d in ("cuda", "cpu"):
                _, logits[d], caches[d] = decode(
                    params[d], {"tokens": cur[:, None].to(d),
                                "pos": pos.to(d)}, caches[d])
            check(f"S {seq} decode logits", logits["cuda"], logits["cpu"])
            cur = logits["cpu"].argmax(-1)
        for got, want in zip(_leaves(caches["cuda"]), _leaves(caches["cpu"])):
            check(f"S {seq} cache", got, want)
    counts = launch_counts()
    if min(counts[k] for k in kernels) < 1:
        raise AssertionError(f"{label} parity missed a kernel: {counts}")
    for name in ("flash_attention_fwd", "ssd_scan"):
        routes = launch_counts_by_route()[name]
        if routes != {"sm90": 0, "cuda_core": counts[name]}:
            raise AssertionError(f"f32 {name} left the CUDA-core route: "
                                 f"{routes}")
    for kind, err in worst.items():
        log(f"[parity] {label} widths, {cfg.num_layers} layers, f32, B 2, "
            f"{kind} max|card-cpu| {err:.3e} (tol {TOL_PARITY})")
    del gpu, params, caches
    torch.cuda.empty_cache()
    return counts


def phase_parity():
    """yi-6b widths at depth 2: the paged steps."""
    from repro_torch.configs import get_config
    _paged_parity(get_config("yi-6b").replace(num_layers=2, dtype="float32"),
                  "yi-6b")


def phase_zamba_parity():
    """Zamba2 widths at depth 6, f32, batch 2: prompts of 256 (two SSD
    chunks) and of 200 (a ragged last chunk of 72 rows, which the reference
    cannot prefill), prefill and four decode steps on the card against the
    CPU."""
    from repro_torch.configs import get_config
    counts = _static_parity(get_config("zamba2-1.2b").replace(
        num_layers=6, dtype="float32"), (ZS, 200), "zamba2")
    if counts["ssd_scan"] < 1:
        raise AssertionError(f"zamba parity missed ssd_scan: {counts}")


def phase_moe_dense_parity():
    """olmoe-1b-7b widths at depth 2, f32: the paged steps, and the static
    prefill and decode at S 256 (one MoE group of 512 tokens) and S 300
    (600 tokens: a group of 512 and a ragged one of 88, which the reference
    cannot route); mistral-nemo-12b widths at depth 2, f32: the static
    prefill and decode at S 256 and 200. Card against CPU."""
    from repro_torch.configs import get_config
    olmoe = get_config("olmoe-1b-7b").replace(num_layers=2, dtype="float32")
    _paged_parity(olmoe, "olmoe-1b-7b")
    _static_parity(olmoe, (ZS, 300), "olmoe-1b-7b")
    _static_parity(get_config("mistral-nemo-12b").replace(
        num_layers=2, dtype="float32"), (ZS, 200), "mistral-nemo-12b")


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

def _route_of(cfg) -> str:
    """The attention kernels' route for the config's compute dtype."""
    return "sm90" if cfg.dtype == "bfloat16" else "cuda_core"


def _continuous_run(cfg, params, label, kw, prompts, max_new, smi):
    """One full-width ``ContinuousBatchingEngine.generate`` (8 slots,
    max_len 512), timed on the host clock around work that ends in a
    synchronise, with the kernels' launches counted around it. Every paged
    launch must take its dtype's route (bf16: sm90, f32: cuda_core), and
    the tokens must be in the vocabulary. Returns (tokens, launches,
    launches by route, decode steps, engine)."""
    import torch
    from repro_torch.kernels import (launch_counts, launch_counts_by_route,
                                     reset_launch_counts)
    from repro_torch.serve import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(cfg, params, max_len=SERVE_MAX_LEN,
                                   max_slots=B, device="cuda", **kw)
    chunks = []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new=max_new,
                       on_chunk=lambda steps, _: chunks.append(steps))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, by_route = launch_counts(), launch_counts_by_route()
    route = _route_of(cfg)
    for kern in PAGED:
        if by_route[kern][route] != counts[kern]:
            raise AssertionError(f"serve {label}: a {cfg.dtype} {kern} "
                                 f"launch left the {route} route: "
                                 f"{by_route[kern]}")
    toks = out.tokens
    if toks.shape != (len(prompts), max_new) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"serve {label}: bad tokens {toks.shape}")
    extra = (f", mean accepted {eng.mean_accepted_len:.2f}"
             if eng.spec_decode else "")
    log(f"[serve] {label} {cfg.num_layers} layers {cfg.dtype}: {len(prompts)} "
        f"prompts x {max_new} new in {dt:.3f} s = {toks.size / dt:.1f} tok/s "
        f"(prefill+decode), prefix hit rate {eng.prefix_hit_rate:.3f}{extra},"
        f" launches {counts} on {smi}")
    return toks, counts, by_route, sum(chunks), eng


def phase_serve(smi: str):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNEL_WRAPPERS
    from repro_torch.models import get_family, init_params
    from repro_torch.serve.prompts import shared_prefix_prompts
    cfg = get_config("yi-6b")
    params = init_params(cfg, get_family(cfg).layout(cfg), seed=0,
                         device="cuda")
    prompts = shared_prefix_prompts(cfg.vocab_size)
    max_new = 32
    total = dict.fromkeys(KERNEL_WRAPPERS, 0)
    paged_routes = {name: {"sm90": 0, "cuda_core": 0} for name in PAGED}
    used = PAGED + ("rmsnorm_fused",)        # the kernels of this path
    outs = {}
    for name, kw in SERVE_RUNS.items():
        toks, counts, by_route, _, eng = _continuous_run(
            cfg, params, f"yi-6b {name}", kw, prompts, max_new, smi)
        if eng.stats["cached_tokens"] <= 0:
            raise AssertionError(f"serve {name}: no prefix-cache hits")
        for kern in PAGED:
            for k, v in by_route[kern].items():
                paged_routes[kern][k] += v
        for k, v in counts.items():
            total[k] += v
        outs[name] = toks
        del eng
        torch.cuda.empty_cache()
    for name in ("spec", "int8"):
        agree = float((outs[name] == outs["plain"]).mean())
        log(f"[serve] tokens equal to plain decode: {name} {agree:.3f}")
    if min(total[k] for k in used) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{total}")
    log(f"[serve] launches on the main path: {total}; paged kernels by "
        f"route {paged_routes}")
    return total, paged_routes


def phase_zamba_serve(smi: str):
    """Full-width Zamba2-1.2B through the static ServeEngine: 8 prompts of
    160-256 tokens padded to 256, 32 new tokens each, max_len 512. Per
    generate the SSD kernel runs once a Mamba layer (38), flash attention
    once a shared application (6), RMSNorm 89 times a pass over 33 passes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import (launch_counts, launch_counts_by_route,
                                     reset_launch_counts)
    from repro_torch.models import get_family, init_params
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.prompts import static_batch_prompts
    cfg = get_config("zamba2-1.2b")
    fam = get_family(cfg)
    params = init_params(cfg, fam.layout(cfg), seed=0, device="cuda")
    n_params = _param_count(params)
    prompts = static_batch_prompts(cfg.vocab_size)
    max_new = 32
    eng = ServeEngine(cfg, params, max_len=SERVE_MAX_LEN, device="cuda")
    eng.generate(prompts, max_new=2)                 # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new=max_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    routes = {name: launch_counts_by_route()[name]
              for name in ("flash_attention_fwd", "ssd_scan")}
    toks = out.tokens
    if toks.shape != (len(prompts), max_new) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"zamba serve: bad tokens {toks.shape}")
    passes = 1 + max_new
    norms = 2 * cfg.num_layers + 2 * fam.n_shared_applications(cfg) + 1
    want = {"ssd_scan": cfg.num_layers,
            "flash_attention_fwd": fam.n_shared_applications(cfg),
            "rmsnorm_fused": norms * passes}
    got = {k: counts[k] for k in want}
    if got != want or any(counts[k] for k in PAGED):
        raise AssertionError(f"zamba serve launches {counts}, expected "
                             f"{want} and no paged kernel")
    for name, r in routes.items():
        if r != {"sm90": want[name], "cuda_core": 0}:
            raise AssertionError(f"zamba serve: a bf16 {name} launch left "
                                 f"the sm90 route: {r}")
    # Untimed: the same prompts cut to 200 tokens at most, so the batch pads
    # to 200 and every scan ends in a ragged chunk of 72 rows.
    ragged = [p[:200] for p in prompts]
    reset_launch_counts()
    rtoks = eng.generate(ragged, max_new=8).tokens
    torch.cuda.synchronize()
    rcounts = launch_counts()
    rssd = launch_counts_by_route()["ssd_scan"]
    if rtoks.shape != (len(ragged), 8) or rtoks.min() < 0 \
            or rtoks.max() >= cfg.vocab_size:
        raise AssertionError(f"zamba serve, longest prompt 200: bad tokens "
                             f"{rtoks.shape}")
    rwant = {"ssd_scan": cfg.num_layers,
             "flash_attention_fwd": fam.n_shared_applications(cfg),
             "rmsnorm_fused": norms * (1 + 8)}
    if {k: rcounts[k] for k in rwant} != rwant \
            or rssd != {"sm90": cfg.num_layers, "cuda_core": 0}:
        raise AssertionError(f"zamba serve, longest prompt 200: launches "
                             f"{rcounts}, SSD by route {rssd}, expected "
                             f"{rwant} all on sm90")
    log(f"[serve] zamba2-1.2b, longest prompt 200 (SSD chunks 128 + 72), 8 "
        f"new: launches {rcounts}, SSD by route {rssd}")
    log(f"[serve] zamba2-1.2b {cfg.num_layers} layers bf16 "
        f"({n_params / 1e9:.3f} B "
        f"params), static engine: {len(prompts)} prompts (padded to "
        f"{max(len(p) for p in prompts)}) x {max_new} new in {dt:.3f} s = "
        f"{toks.size / dt:.1f} tok/s (prefill+decode), launches {counts}, "
        f"by route {routes} on {smi}")
    del eng, params
    torch.cuda.empty_cache()
    return counts, routes


# ---------------------------------------------------------------------------
# phase 5b: the dense and MoE transformers at full width
# ---------------------------------------------------------------------------

def _static_run(cfg, params, label, prompts, max_new, smi, timed=True):
    """One full-width ``ServeEngine.generate`` (max_len 512), after a
    warm-up call when timed. Its launches are exact: flash attention once a
    layer (one prefill), RMSNorm 2L + 1 times a pass over 1 + max_new
    passes (the MoE block's norm is the FFN's), no paged kernel and no SSD
    scan, every flash launch on the sm90 route. Returns (tokens, launches,
    seconds)."""
    import torch
    from repro_torch.kernels import (launch_counts, launch_counts_by_route,
                                     reset_launch_counts)
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, max_len=SERVE_MAX_LEN, device="cuda")
    if timed:
        eng.generate(prompts, max_new=2)                 # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new=max_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    flash = launch_counts_by_route()["flash_attention_fwd"]
    n = cfg.num_layers
    want = {"flash_attention_fwd": n,
            "rmsnorm_fused": (2 * n + 1) * (1 + max_new)}
    if {k: counts[k] for k in want} != want \
            or any(counts[k] for k in PAGED + ("ssd_scan",)) \
            or flash != {"sm90": n, "cuda_core": 0}:
        raise AssertionError(f"static {label}: launches {counts}, flash by "
                             f"route {flash}, expected {want}, all on sm90, "
                             f"and no paged kernel or SSD scan")
    toks = out.tokens
    if toks.shape != (len(prompts), max_new) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"static {label}: bad tokens {toks.shape}")
    plen = max(len(p) for p in prompts)
    rate = (f" in {dt:.3f} s = {toks.size / dt:.1f} tok/s (prefill+decode)"
            if timed else " (untimed)")
    log(f"[serve] {label} {n} layers bf16, static engine: {len(prompts)} "
        f"prompts (padded to {plen}) x {max_new} new{rate}, launches "
        f"{counts}, flash by route {flash} on {smi}")
    return toks, counts, dt


def _param_count(params) -> int:
    return sum(t.numel() for t in _leaves(params))


def _end_model_phase(label, t0, smi):
    """Log the phase's peak device memory and seconds; return both."""
    import torch
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    dt = time.perf_counter() - t0
    log(f"[serve] {label}: peak device memory {peak / 2**30:.2f} GiB, "
        f"phase {dt:.1f} s, on {smi}")
    torch.cuda.empty_cache()
    return {"max_memory_allocated_bytes": peak, "seconds": dt}


def phase_moe_serve(smi: str):
    """Full-width olmoe-1b-7b (16 layers, 64 experts top 8, bf16, seed 0):
    the continuous engine's three serve runs over the serve phase's 8
    prompts (32 new tokens), every bf16 paged launch on sm90; then the
    static engine over the Zamba2 phase's 8 prompts of 160-256 tokens (one
    prefill of 2048 tokens: four MoE groups of 512), timed, and untimed at
    a longest prompt of 200 (1600 tokens: a ragged last group of 64, which
    the reference cannot route), flash and RMSNorm launches exact."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_family, init_params
    from repro_torch.serve.prompts import (shared_prefix_prompts,
                                           static_batch_prompts)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("olmoe-1b-7b")
    params = init_params(cfg, get_family(cfg).layout(cfg), seed=0,
                         device="cuda")
    log(f"[serve] olmoe-1b-7b: {_param_count(params) / 1e9:.3f} B params")
    launches, outs = {}, {}
    for name, kw in SERVE_RUNS.items():
        toks, counts, _, _, eng = _continuous_run(
            cfg, params, f"olmoe-1b-7b {name}", kw,
            shared_prefix_prompts(cfg.vocab_size), 32, smi)
        launches[f"olmoe-1b-7b continuous {name}"] = counts
        outs[name] = toks
        del eng
        torch.cuda.empty_cache()
    for kern in PAGED + ("rmsnorm_fused",):
        if not sum(c[kern] for c in launches.values()):
            raise AssertionError(f"olmoe-1b-7b continuous: {kern} was not "
                                 f"launched: {launches}")
    for name in ("spec", "int8"):
        agree = float((outs[name] == outs["plain"]).mean())
        log(f"[serve] olmoe-1b-7b tokens equal to plain decode (reported: "
            f"MoE routing depends on the batch): {name} {agree:.3f}")
    prompts = static_batch_prompts(cfg.vocab_size)
    _, counts, _ = _static_run(cfg, params, "olmoe-1b-7b", prompts, 32, smi)
    launches["olmoe-1b-7b static"] = counts
    _, counts, _ = _static_run(cfg, params, "olmoe-1b-7b, longest prompt "
                               "200 (MoE groups 3 x 512 + 64)",
                               [p[:200] for p in prompts], 8, smi,
                               timed=False)
    launches["olmoe-1b-7b static S 200"] = counts
    del params
    return launches, _end_model_phase("olmoe-1b-7b", t0, smi)


def _dense_admission_identity(cfg, params, prompts, smi, label):
    """The continuous engine with paged and with dense admission on the
    same prompts, whose tokens must be equal (a dense config: no expert
    capacity for the pads to compete for); returns the two runs' launches.
    The dense run's launches are exact: flash attention once a layer a pad
    bucket (one wave, one bucket a distinct page count), RMSNorm 2L + 1 a
    pass over the buckets and the decode steps, paged decode once a layer
    a step, no paged prefill."""
    toks_p, counts_p, _, _, eng = _continuous_run(
        cfg, params, f"{label} paged", {}, prompts, 32, smi)
    del eng
    toks_d, counts, by_route, steps, eng = _continuous_run(
        cfg, params, f"{label} dense prefill", dict(prefill_mode="dense"),
        prompts, 32, smi)
    del eng
    n = cfg.num_layers
    buckets = len({math.ceil(len(p) / PS) * PS for p in prompts})
    want = {"flash_attention_fwd": n * buckets,
            "rmsnorm_fused": (2 * n + 1) * (buckets + steps),
            "flash_decode_fwd": n * steps, "flash_prefill_fwd": 0}
    flash = by_route["flash_attention_fwd"]
    if {k: counts[k] for k in want} != want \
            or flash[_route_of(cfg)] != want["flash_attention_fwd"]:
        raise AssertionError(f"{label} dense prefill: launches {counts}, "
                             f"flash by route {flash}, expected {want} on "
                             f"{_route_of(cfg)}")
    if not (toks_p == toks_d).all():
        same = sum(bool((a == b).all()) for a, b in zip(toks_p, toks_d))
        raise AssertionError(f"{label}: dense admission's tokens differ from "
                             f"paged admission's in {len(prompts) - same} of "
                             f"{len(prompts)} streams")
    log(f"[serve] {label} dense vs paged admission: every token of "
        f"{len(prompts)} streams equal")
    return counts_p, counts


def phase_dense_serve(smi: str):
    """Full-width mistral-nemo-12b (40 layers, G 4, bf16, seed 0): the
    static engine over the Zamba2 phase's prompts (timed, and untimed at a
    longest prompt of 200), flash and RMSNorm launches exact; the
    continuous engine over the serve phase's prompts with paged and with
    dense admission (``prefill_mode="dense"``), whose tokens must be equal,
    the dense run's launches exact; then the same two admissions in
    float32 (the CUDA-core routes), held alike."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_family, init_params
    from repro_torch.serve.prompts import (shared_prefix_prompts,
                                           static_batch_prompts)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("mistral-nemo-12b")
    params = init_params(cfg, get_family(cfg).layout(cfg), seed=0,
                         device="cuda")
    log(f"[serve] mistral-nemo-12b: {_param_count(params) / 1e9:.3f} B "
        f"params")
    launches = {}
    prompts = static_batch_prompts(cfg.vocab_size)
    _, launches["mistral-nemo-12b static"], _ = _static_run(
        cfg, params, "mistral-nemo-12b", prompts, 32, smi)
    _, launches["mistral-nemo-12b static S 200"], _ = _static_run(
        cfg, params, "mistral-nemo-12b, longest prompt 200",
        [p[:200] for p in prompts], 8, smi, timed=False)
    shared = shared_prefix_prompts(cfg.vocab_size)
    (launches["mistral-nemo-12b continuous paged"],
     launches["mistral-nemo-12b continuous dense prefill"]) = \
        _dense_admission_identity(cfg, params, shared, smi,
                                  "mistral-nemo-12b")
    del params
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32")
    params = init_params(cfg32, get_family(cfg32).layout(cfg32), seed=0,
                         device="cuda")
    _dense_admission_identity(cfg32, params, shared, smi,
                              "mistral-nemo-12b f32")
    del params
    return launches, _end_model_phase("mistral-nemo-12b", t0, smi)


def phase_arctic_serve(smi: str):
    """arctic-480b at full widths and depth 1 (128 experts top 2 beside
    the dense residual FFN, bf16, seed 0; one layer and the embeddings are
    14.27 B parameters) through the static engine, untimed: the Zamba2
    phase's 8 prompts, 8 new tokens, launches exact."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_family, init_params
    from repro_torch.serve.prompts import static_batch_prompts
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("arctic-480b").replace(num_layers=1)
    params = init_params(cfg, get_family(cfg).layout(cfg), seed=0,
                         device="cuda")
    log(f"[serve] arctic-480b depth 1: {_param_count(params) / 1e9:.3f} B "
        f"params")
    _, counts, _ = _static_run(cfg, params, "arctic-480b",
                               static_batch_prompts(cfg.vocab_size), 8, smi,
                               timed=False)
    del params
    return {"arctic-480b static": counts}, _end_model_phase(
        "arctic-480b depth 1", t0, smi)


# ---------------------------------------------------------------------------
# phase 6: the residency surface at full width
# ---------------------------------------------------------------------------

# The residency and gateway phases hold tokens exactly across moves and
# scheduling, which no layer count changes, so they run yi-6b at half depth
# (16 of 32 layers; every width full): at full depth the two took 117.7 and
# 178.9 s of a 874.9 s whole run on an H100, and the frontends' training
# needs that room in the script's 1,200 s.
YI_CUT_LAYERS = 16
RESIDENCY_CHUNK = 4          # decode steps a chunk: 32 new tokens take 8+


def _drain(*engines):
    """Admit and decode on every engine until all are idle; returns
    {rid: tokens} over all of them."""
    done = {}
    for _ in range(1000):
        if not any(e.has_work for e in engines):
            return done
        for e in engines:
            e.admit()
            for req, toks in e.decode_step():
                done[req.rid] = toks
            e._debug_check_refcounts()
    raise AssertionError("residency: engines did not drain")


def _check_tokens(what, done, gold):
    import numpy as np
    got = np.stack([np.asarray(done[i], np.int32) for i in range(len(gold))])
    if not np.array_equal(got, gold):
        bad = sorted({int(r) for r in np.nonzero(got != gold)[0]})
        first = {r: int(np.nonzero(got[r] != gold[r])[0][0]) for r in bad}
        raise AssertionError(f"residency {what}: tokens differ from the "
                             f"uninterrupted run in requests {bad} (first "
                             f"differing step {first})")


def _time_moves(mk, prompts, max_new, gold):
    """Export all 8 requests from one engine after a chunk and import them
    into another, each call timed alone (host clock, synchronised before
    and after); the destination then finishes them. Returns the medians."""
    import torch
    from repro_torch.serve import EngineRequest, ExportReason
    src, dst = mk(), mk()
    for i, p in enumerate(prompts):
        src.enqueue(EngineRequest(i, p, max_new))
    src.admit()
    src.decode_step()
    t_exp, t_imp, nbytes = [], [], []
    payloads = []
    for slot in sorted(src._live):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pl = src.export(slot=slot, reason=ExportReason.EVACUATE)
        torch.cuda.synchronize()
        t_exp.append(time.perf_counter() - t0)
        nbytes.append(pl.nbytes)
        payloads.append(pl)
    for pl in payloads:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst.import_pages(pl)
        torch.cuda.synchronize()
        t_imp.append(time.perf_counter() - t0)
    _check_tokens("export/import of all 8", _drain(dst), gold)
    med = statistics.median
    return {"export_ms": med(t_exp) * 1e3, "import_ms": med(t_imp) * 1e3,
            "bytes": med(nbytes),
            "export_gb_s": med(b / t for b, t in zip(nbytes, t_exp)) / 1e9,
            "import_gb_s": med(b / t for b, t in zip(nbytes, t_imp)) / 1e9,
            "page_nbytes": src.page_nbytes()}


def _residency_variant(name, mk, prompts, max_new, tail):
    """Preempt/resume, evacuate (a live and a paused request into a second
    engine) and demote/restore (HOST and OBJECT tiers) for one engine
    configuration, each held to the uninterrupted run's tokens exactly."""
    import torch
    from repro_torch.serve import (EngineRequest, ExportReason, Tier,
                                   TieredKVStore)
    ns = ("tenant0", "public")
    gold = mk().generate(prompts, max_new=max_new).tokens

    # 1. preempt two slots for a chunk, then resume them
    eng = mk()
    for i, p in enumerate(prompts):
        eng.enqueue(EngineRequest(i, p, max_new))
    eng.admit()
    eng.decode_step()
    live = sorted(eng._live)
    if len(live) < len(prompts):
        raise AssertionError(f"residency {name}: a request finished in the "
                             "first chunk")
    paused = [eng.preempt(live[1]), eng.preempt(live[4])]
    done = {req.rid: toks for req, toks in eng.decode_step()}
    for pr in paused:
        eng.resume(pr)
    if eng.stats["preempted"] != 2 or eng.stats["resumed"] != 2:
        raise AssertionError(f"residency {name}: stats {eng.stats}")
    done.update(_drain(eng))
    _check_tokens(f"{name} preempt/resume", done, gold)

    # 2. evacuate a live and a paused request into engine b
    a, b = mk(), mk()
    for i, p in enumerate(prompts):
        a.enqueue(EngineRequest(i, p, max_new))
    a.admit()
    a.decode_step()
    live = sorted(a._live)
    parked = a.preempt(live[2])
    shipped = [a.export(slot=live[5], reason=ExportReason.EVACUATE),
               a.export(rid=parked.req.rid, reason=ExportReason.EVACUATE)]
    for pl in shipped:
        b.import_pages(pl)
    for pl in shipped:
        try:
            b.import_pages(pl)
        except ValueError:
            continue
        raise AssertionError(f"residency {name}: a payload imported twice")
    _check_tokens(f"{name} evacuate", _drain(a, b), gold)

    # 3. demote every finished stream, with HOST room for about half of
    # them; restore one from each tier into a fresh engine and extend it
    eng = mk()
    eng.demote_on_retire = True
    for i, p in enumerate(prompts):
        eng.enqueue(EngineRequest(i, p, max_new, namespace=ns))
    _check_tokens(f"{name} demote on retire", _drain(eng), gold)
    out = eng.demoted_out
    if len(out) != len(prompts):
        raise AssertionError(f"residency {name}: {len(out)} demotions")
    kept = {pl.req.rid: {k: t.clone() for k, t in pl.content.items()}
            for pl in out}
    store = TieredKVStore(host_capacity_bytes=sum(pl.nbytes for pl in out)
                          // 2)
    for t, pl in enumerate(out):
        store.demote(pl, "tenant0", now=float(t))
    streams = [list(p) + [int(x) for x in g] for p, g in zip(prompts, gold)]
    tiers = [store.tier_of((ns, tuple(st))) for st in streams]
    picks = [max(r for r, t in enumerate(tiers) if t is Tier.HOST),
             min(r for r, t in enumerate(tiers) if t is Tier.OBJECT)]
    restored = {}
    for rid in picks:
        stream = streams[rid]
        ext = stream + tail
        key, n, tier = store.match(ns, ext)
        if n != len(stream) or tier is not tiers[rid]:
            raise AssertionError(f"residency {name}: match {n}, {tier}")
        payload = store.complete_restore(store.request_restore(key, rid,
                                                               now=100.0))
        for k, t in payload.content.items():
            if not torch.equal(t.view(torch.uint8), kept[rid][k]
                               .view(torch.uint8)):
                raise AssertionError(f"residency {name}: {tier.value} "
                                     f"round trip changed {k}")
        # The restored engine, and its twin restored from the copy taken
        # before the store ever held the payload: the same KV, bit for bit,
        # so the same tokens exactly.
        got = {}
        for who, pl in (("store", payload),
                        ("twin", dataclasses.replace(payload,
                                                     content=kept[rid]))):
            dst = mk()
            pages = dst.restore_pages(pl)
            idx = torch.tensor(pages, device="cuda")
            for k, t in pl.content.items():
                if not torch.equal(dst.pool[k][:, :, idx].cpu(), t):
                    raise AssertionError(f"residency {name}: restored {k} "
                                         "differs from the payload")
            dst.enqueue(EngineRequest("ext", ext, 8, namespace=ns))
            got[who] = _drain(dst)["ext"]
            cached = dst.stats["cached_tokens"]
            full = len(stream) // PS * PS
            if cached < full or \
                    dst.stats["prefill_tokens"] != len(ext) - cached:
                raise AssertionError(
                    f"residency {name}: {tier.value} restore cached {cached} "
                    f"of {len(ext)} tokens (restored full pages hold {full}),"
                    f" prefilled {dst.stats['prefill_tokens']}")
        if got["store"] != got["twin"]:
            raise AssertionError(
                f"residency {name}: {tier.value} restore extends to "
                f"{got['store']}, the store-free restore to {got['twin']}")
        restored[tier.value] = dict(
            rid=rid, cached=cached, prompt=len(ext),
            **_against_fresh(mk, ext, ns, kept[rid], len(prompts[rid]),
                             len(stream), got["store"]))
    return restored


def _against_fresh(mk, ext, ns, content, plen, slen, got):
    """A fresh engine on the extended prompt recomputes the whole stream in
    prefill chunks at batch 1, where the restored pages hold KV from the
    batch-8 prefill and from decode steps. Measured, not held: its tokens'
    agreement with the restored engine's, and over the stream's full pages
    the share of K/V values that differ (prompt and generated positions
    apart) and the largest difference (in the pool's own units: bf16
    values, or int8 steps)."""
    import torch
    from repro_torch.serve import EngineRequest
    fresh = mk()
    fresh.enqueue(EngineRequest("ext", ext, 8, namespace=ns))
    want = _drain(fresh)["ext"]
    n = slen // PS                               # the stream's full pages
    chain, _ = fresh.prefix_cache.lookup(ext, ns)
    idx = torch.tensor(chain[:n], device="cuda")
    share_p, share_g, worst = [], [], 0.0
    for k in ("k", "v"):
        mine = fresh.pool[k][:, :, idx].cpu().float()
        theirs = content[k][:, :, :n].float()
        # (L, KV, n, ps, hd) -> (position, values)
        d = (mine - theirs).abs().permute(2, 3, 0, 1, 4).reshape(n * PS, -1)
        share_p.append(float((d[:plen] > 0).float().mean()))
        share_g.append(float((d[plen:] > 0).float().mean()))
        worst = max(worst, float(d.max()))
    return {"fresh_tokens_equal": sum(a == b for a, b in zip(got, want)),
            "fresh_first_differing": next(
                (i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                None),
            "kv_values_differ_prompt": max(share_p),
            "kv_values_differ_generated": max(share_g),
            "kv_max_abs_diff": worst}


def phase_residency(smi: str):
    """The residency surface on full-width yi-6b at YI_CUT_LAYERS layers
    (bf16 weights from seed 0), the serve phase's 8 prompts, 32 new tokens, 8 slots,
    max_len 512, decode chunks of RESIDENCY_CHUNK steps: bf16 and int8
    pools, plain and speculative (K=4); the moves timed on the plain
    engines."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import (launch_counts, launch_counts_by_route,
                                     reset_launch_counts)
    from repro_torch.models import get_family, init_params
    from repro_torch.serve import ContinuousBatchingEngine
    from repro_torch.serve.prompts import shared_prefix_prompts
    cfg = get_config("yi-6b").replace(num_layers=YI_CUT_LAYERS)
    params = init_params(cfg, get_family(cfg).layout(cfg), seed=0,
                         device="cuda")
    prompts = shared_prefix_prompts(cfg.vocab_size)
    tail = [7, 11, 13, 17]
    max_new = 32
    variants = {"bf16": {}, "bf16 spec": dict(enable_spec_decode=True,
                                              spec_tokens=4),
                "int8": dict(kv_cache_dtype="int8"),
                "int8 spec": dict(kv_cache_dtype="int8",
                                  enable_spec_decode=True, spec_tokens=4)}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    moves = {}
    for name, kw in variants.items():
        def mk(kw=kw):
            return ContinuousBatchingEngine(
                cfg, params, max_len=SERVE_MAX_LEN, max_slots=B,
                decode_chunk=RESIDENCY_CHUNK, device="cuda", **kw)
        restored = _residency_variant(name, mk, prompts, max_new, tail)
        log(f"[residency] yi-6b {name}: preempt/resume, evacuate and "
            f"demote/restore token-identical to the uninterrupted run; "
            f"restored {restored}")
        if "spec" not in name:
            gold = mk().generate(prompts, max_new=max_new).tokens
            m = moves[name] = _time_moves(mk, prompts, max_new, gold)
            log(f"[residency] yi-6b {name} pool, a request after one chunk "
                f"(median of 8): export {m['export_ms']:.3f} ms, "
                f"import_pages {m['import_ms']:.3f} ms, "
                f"{m['bytes'] / 1e6:.3f} MB ({m['page_nbytes']} B a page): "
                f"{m['export_gb_s']:.2f} GB/s device to host, "
                f"{m['import_gb_s']:.2f} GB/s host to device, on {smi}")
    torch.cuda.synchronize()
    counts, by_route = launch_counts(), launch_counts_by_route()
    for kern in PAGED + ("rmsnorm_fused",):
        if counts[kern] <= 0:
            raise AssertionError(f"residency: {kern} not launched {counts}")
    for kern in PAGED:
        if by_route[kern] != {"sm90": counts[kern], "cuda_core": 0}:
            raise AssertionError(f"residency: a bf16 {kern} launch left the "
                                 f"sm90 route: {by_route[kern]}")
    log(f"[residency] {time.perf_counter() - t0:.1f} s, launches {counts}")
    del params
    torch.cuda.empty_cache()
    return moves


# ---------------------------------------------------------------------------
# phase 7: the Kotta serving gateway at full width
# ---------------------------------------------------------------------------

GATEWAY_CHUNK = 4            # decode steps a chunk
GATEWAY_NEW = 32             # new tokens a request
GATEWAY_NOTICE_S = 120.0     # the spot market's revocation notice
GATEWAY_VARIANTS = {"bf16": {}, "bf16 spec": dict(enable_spec_decode=True,
                                                  spec_tokens=4),
                    "int8": dict(kv_cache_dtype="int8"),
                    "int8 spec": dict(kv_cache_dtype="int8",
                                      enable_spec_decode=True, spec_tokens=4)}
ENGINE_API = ("admit", "decode_step", "export", "import_pages",
              "restore_pages")


class _EngineTimer:
    """Wall time inside the engines' stepped API, over every engine a
    gateway builds: each outermost call of ``ENGINE_API`` is bracketed by a
    device synchronise, so the device work it queued is charged to it (a
    call made inside another, such as the export a demoting
    ``decode_step`` makes, is part of that one). Keeps one sample a call
    (method, seconds, prefill tokens, payload bytes, export reason) for the
    service rates."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds = 0.0
        self.calls: list[dict] = []
        self._depth = 0

    def wrap(self, eng):
        for name in ENGINE_API:
            setattr(eng, name, self._timed(eng, name, getattr(eng, name)))
        return eng

    def _timed(self, eng, name, fn):
        def call(*args, **kw):
            if self._depth:
                return fn(*args, **kw)
            pt = eng.stats["prefill_tokens"]
            self.sync()
            t0 = time.perf_counter()
            self._depth += 1
            try:
                out = fn(*args, **kw)
            finally:
                self._depth -= 1
            self.sync()
            dt = time.perf_counter() - t0
            self.seconds += dt
            payload = out if name == "export" else \
                args[0] if name in ("import_pages", "restore_pages") else None
            self.calls.append({
                "name": name, "s": dt,
                "prefill_tokens": eng.stats["prefill_tokens"] - pt,
                "bytes": payload.nbytes if payload is not None else 0,
                "reason": getattr(kw.get("reason"), "value", None)})
            return out
        return call


def _gateway_engine(cfg, params, device, timer=None, **kw):
    """A replica's engine: 8 slots, max_len 512, ``GATEWAY_CHUNK`` steps a
    decode chunk, over the shared ``params``; timed by ``timer``."""
    from repro_torch.serve import ContinuousBatchingEngine
    kw.setdefault("decode_chunk", GATEWAY_CHUNK)
    eng = ContinuousBatchingEngine(cfg, params, max_len=SERVE_MAX_LEN,
                                   max_slots=B, device=device, **kw)
    return timer.wrap(eng) if timer is not None else eng


def _direct_generates(cfg, params, device, sync):
    """Tokens/s of one direct ``generate`` of the 8 prompts a variant: the
    yardstick for the same prompts through the gateway."""
    from repro_torch.serve.prompts import shared_prefix_prompts
    prompts = shared_prefix_prompts(cfg.vocab_size)
    direct = {}
    for name, kw in GATEWAY_VARIANTS.items():
        eng = _gateway_engine(cfg, params, device, **kw)
        sync()
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new=GATEWAY_NEW)
        sync()
        direct[name] = out.tokens.size / (time.perf_counter() - t0)
    return direct


def _gateway_scenarios(cfg, params, device, sync, log_line, direct):
    """The six gateway scenarios on ``cfg``'s model (every engine shares
    ``params``): held checks raise, reported numbers are returned."""
    from repro_torch.core import (PolicyEngine, ScalingPolicy, StateStore,
                                  VirtualClock, provision_tenant)
    from repro_torch.serve import (DeadlineCostPolicy, JobState,
                                   KottaServeGateway, ServiceModel,
                                   TieredKVStore, TrafficConfig,
                                   generate_trace, run_open_loop)
    from repro_torch.serve.prompts import shared_prefix_prompts
    prompts = shared_prefix_prompts(cfg.vocab_size)
    svc = ServiceModel()
    tenants = ("tenant0", "tenant1")

    def engine(timer, **kw):
        return _gateway_engine(cfg, params, device, timer, **kw)

    def gateway(timer, kw, *, replicas=2, telemetry=False, **gw_kw):
        sec = PolicyEngine(clock=VirtualClock())
        toks = [provision_tenant(sec, t, f"pw-{t}", data_zones=("public",))
                for t in tenants]
        gw_kw.setdefault("admission", DeadlineCostPolicy(model=svc))
        if telemetry:
            gw_kw["telemetry_store"] = StateStore(clock=sec.clock,
                                                  write_capacity=200.0)
        gw = KottaServeGateway(
            lambda: engine(timer, **kw), sec, service_model=svc,
            scaling=ScalingPolicy.none(replicas, market="on_demand"),
            routing="affinity", **gw_kw)
        return gw, sec, toks

    def engines(gw):
        return [r.engine for r in gw.replicas()] + list(gw._standby)

    def two_waves(gw, toks, hook=None):
        """The launcher's two waves: one prompt a tenant, drained; then the
        rest. ``hook(gw, wave)`` runs after each round. Returns the rids."""
        n, rids = len(toks), []
        for wave, part in ((1, prompts[:n]), (2, prompts[n:])):
            rids += [gw.submit(toks[i % n], p, max_new=GATEWAY_NEW,
                               data_zone="public")
                     for i, p in enumerate(part)]
            for _ in range(20_000):
                if not gw.outstanding():
                    break
                gw.step()
                if hook is not None:
                    hook(gw, wave)
            else:
                raise AssertionError(f"gateway: wave {wave} did not drain")
        return rids

    def done_tokens(what, gw, rids):
        out = {}
        for rid in rids:
            job = gw.jobs[rid]
            if job.status is not JobState.DONE:
                raise AssertionError(f"gateway {what}: job {rid} "
                                     f"{job.status.value} ({job.error})")
            toks = [int(t) for t in job.tokens]
            if len(toks) != GATEWAY_NEW or min(toks) < 0 \
                    or max(toks) >= cfg.vocab_size:
                raise AssertionError(f"gateway {what}: job {rid} tokens "
                                     f"{toks}")
            out[rid] = toks
        return out

    def report(what, gw, timer, wall, tokens, direct_tps):
        rounds = gw.stats["rounds"]
        host = (wall - timer.seconds) / wall
        row = {"rounds": rounds, "wall_s": wall,
               "wall_ms_a_round": wall / rounds * 1e3,
               "host_share_outside_engine": host,
               "tok_s": tokens / wall, "direct_generate_tok_s": direct_tps}
        log_line(f"[gateway] {what}: {rounds} rounds, {wall:.3f} s wall, "
                 f"{row['wall_ms_a_round']:.1f} ms a round, host share "
                 f"outside the engine {host:.3f}, {tokens} tokens at "
                 f"{row['tok_s']:.1f} tok/s through the gateway (direct "
                 f"generate {direct_tps:.1f} tok/s)")
        for e in engines(gw):
            if e.params is not params:
                raise AssertionError(f"gateway {what}: an engine holds its "
                                     "own parameter tree")
        return row

    def agree(got, want):
        return sum(got[r] == want[r] for r in want)

    results = {}
    # 1. undisturbed fleet and 2. notice-window evacuation, per variant
    gold, rates, ship = {}, {}, []
    for name, kw in GATEWAY_VARIANTS.items():
        timer = _EngineTimer(sync)
        gw, sec, toks = gateway(timer, kw)
        t0 = time.perf_counter()
        rids = two_waves(gw, toks)
        sync()
        wall = time.perf_counter() - t0
        gold[name] = done_tokens(f"undisturbed {name}", gw, rids)
        results[f"undisturbed {name}"] = report(
            f"1 undisturbed fleet, {name}", gw, timer, wall,
            sum(map(len, gold[name].values())), direct[name])
        if name == "bf16":
            admits = [c for c in timer.calls
                      if c["name"] == "admit" and c["prefill_tokens"]]
            steps = [c["s"] for c in timer.calls
                     if c["name"] == "decode_step"]
            rates["prefill_tok_s"] = sum(c["prefill_tokens"] for c in admits) \
                / sum(c["s"] for c in admits)
            rates["decode_step_s"] = statistics.median(steps) / GATEWAY_CHUNK
        del gw
        gc.collect()

        timer = _EngineTimer(sync)
        gw, sec, toks = gateway(timer, kw)
        state = {}

        def revoke(gw, wave, state=state):
            if state or wave == 1:
                return
            busy = [r for r in gw.replicas() if r.engine.live and all(
                l.emitted > 0 for l in r.engine._live.values())]
            if busy:
                victim = max(busy, key=lambda r: (r.engine.live, -r.id))
                state.update(live=victim.engine.live, id=victim.id,
                             mark=len(timer.calls))
                gw.revoke_replica(victim.id, notice_s=GATEWAY_NOTICE_S)
        t0 = time.perf_counter()
        rids = two_waves(gw, toks, revoke)
        sync()
        wall = time.perf_counter() - t0
        m = gw.metrics()
        got = done_tokens(f"evacuation {name}", gw, rids)
        moved = [c for c in timer.calls[state["mark"]:]
                 if (c["name"] == "export" and c["reason"] == "evacuate")
                 or c["name"] == "import_pages"]
        shipped = sum(c["bytes"] for c in moved if c["name"] == "export")
        evac = [a for a in sec.audit.records()
                if a.action == "serve:Evacuate"]
        if m["evacuations"] != state["live"] or m["requeues"] or \
                m["retries"] or len(evac) != state["live"] or \
                m["evacuated_pages_bytes"] != shipped or \
                sum(c["name"] == "import_pages" for c in moved) \
                != state["live"]:
            raise AssertionError(
                f"gateway evacuation {name}: {state['live']} live on replica "
                f"{state['id']}, evacuations {m['evacuations']}, requeues "
                f"{m['requeues']}, retries {m['retries']}, {len(evac)} "
                f"Evacuate records, {m['evacuated_pages_bytes']} B counted "
                f"vs {shipped} B exported")
        if got != gold[name]:
            bad = sorted(r for r in got if got[r] != gold[name][r])
            raise AssertionError(f"gateway evacuation {name}: tokens of jobs "
                                 f"{bad} differ from the undisturbed fleet's")
        evac_s = sum(c["s"] for c in moved)
        row = report(f"2 notice-window evacuation, {name}", gw, timer, wall,
                     sum(map(len, got.values())), direct[name])
        row.update(evacuated=state["live"], evacuated_bytes=shipped,
                   evacuation_wall_s=evac_s,
                   model_ship_s=svc.ship_s(shipped),
                   notice_s=GATEWAY_NOTICE_S)
        results[f"evacuation {name}"] = row
        log_line(f"[gateway] 2 {name}: {state['live']} live requests "
                 f"evacuated off replica {state['id']} (tokens equal to the "
                 f"undisturbed fleet's, 0 requeues): {shipped} B in "
                 f"{evac_s * 1e3:.2f} ms of exports and imports "
                 f"({shipped / evac_s / 1e9:.2f} GB/s), ServiceModel ship "
                 f"estimate {svc.ship_s(shipped) * 1e3:.2f} ms, against a "
                 f"{GATEWAY_NOTICE_S:.0f} s notice")
        ship.append(shipped / evac_s)
        del gw
        gc.collect()
    for name in GATEWAY_VARIANTS:
        if name != "bf16":
            log_line(f"[gateway] undisturbed {name} tokens equal to bf16 "
                     f"plain's: {agree(gold[name], gold['bf16'])} of "
                     f"{len(prompts)} jobs (reported)")

    # 3. a notice too short for any payload: requeue with backoff
    timer = _EngineTimer(sync)
    gw, sec, toks = gateway(timer, {})
    short = svc.ship_s(engines(gw)[0].page_nbytes()) / 2
    state = {}

    def short_notice(gw, wave):
        if not state and wave == 2:
            victim = max(gw.replicas(), key=lambda r: (r.engine.live, -r.id))
            state["live"] = victim.engine.live
            gw.revoke_replica(victim.id, notice_s=short)
    t0 = time.perf_counter()
    rids = two_waves(gw, toks, short_notice)
    sync()
    wall = time.perf_counter() - t0
    m = gw.metrics()
    got = done_tokens("short notice", gw, rids)
    worst = max(gw.jobs[r].retries for r in rids)
    if m["evacuations"] or not m["requeues"] or worst > gw.retry_budget \
            or m["completed"] != len(prompts) or m["shed"]:
        raise AssertionError(f"gateway short notice: {m['evacuations']} "
                             f"evacuations, {m['requeues']} requeues, "
                             f"retries up to {worst}")
    row = report(f"3 notice of {short * 1e6:.1f} us", gw, timer, wall,
                 sum(map(len, got.values())), direct["bf16"])
    row.update(requeues=m["requeues"], equal_to_undisturbed=agree(
        got, gold["bf16"]))
    results["short notice"] = row
    log_line(f"[gateway] 3: {state['live']} live requests, 0 evacuated, "
             f"{m['requeues']} requeued (retries <= {worst}), tokens equal "
             f"to the undisturbed fleet's for {row['equal_to_undisturbed']} "
             f"of {len(prompts)} jobs (reported)")
    del gw
    gc.collect()

    # 4. disaggregated 1:1: a prefill replica ships to a decode replica
    timer = _EngineTimer(sync)
    gw, sec, toks = gateway(
        timer, {"role": "decode"}, replicas=1, prefill_replicas=1,
        prefill_engine_factory=lambda: engine(timer, role="prefill",
                                              prefill_chunk=2 * C_PREFILL))
    dec = next(r.engine for r in gw.replicas() if r.role == "decode")
    registered = {}
    imported = dec.import_pages

    def import_and_check(payload):
        # the shipped prompt's full pages are hittable on arrival
        slot = imported(payload)
        req = payload.req
        registered[req.rid] = dec.prefix_cache.lookup(
            req.prompt, req.namespace)[1] >= len(req.prompt) // PS * PS
        return slot
    dec.import_pages = import_and_check
    t0 = time.perf_counter()
    rids = two_waves(gw, toks)
    sync()
    wall = time.perf_counter() - t0
    m = gw.metrics()
    got = done_tokens("disaggregated", gw, rids)
    unregistered = [r for r in rids if not registered.get(r)]
    if m["page_ships"] != len(prompts) or unregistered or \
            dec.stats["page_imports"] != len(prompts) or \
            dec.stats["prefill_tokens"]:
        raise AssertionError(f"gateway disaggregated: {m['page_ships']} "
                             f"ships, {dec.stats['page_imports']} imports, "
                             f"prefixes not registered {unregistered}")
    row = report("4 disaggregated 1:1", gw, timer, wall,
                 sum(map(len, got.values())), direct["bf16"])
    row.update(page_ships=m["page_ships"],
               bytes_a_ship=m["page_ship_bytes_per_ship"],
               equal_to_undisturbed=agree(got, gold["bf16"]))
    results["disaggregated"] = row
    log_line(f"[gateway] 4: {m['page_ships']} ships of "
             f"{m['page_ship_bytes_per_ship'] / 1e6:.3f} MB, every prompt's "
             f"full pages registered on the decode replica; tokens equal to "
             f"the undisturbed fleet's for {row['equal_to_undisturbed']} of "
             f"{len(prompts)} jobs (reported)")
    del gw
    gc.collect()

    # 5. tiered KV: later requests extend the first waves' streams, which
    # were demoted at retirement and are restored. Six extensions arrive at
    # once (reported: restores landing in one round can evict each other's
    # free pages before admission), then two one at a time (held: the
    # admission serves the whole stream from the restored pages).
    timer = _EngineTimer(sync)
    store = TieredKVStore(host_capacity_bytes=1 << 34)
    gw, sec, toks = gateway(timer, {}, kv_store=store)
    t0 = time.perf_counter()
    first = two_waves(gw, toks)
    streams = {r: list(gw.jobs[r].prompt)
               + [int(t) for t in gw.jobs[r].tokens] for r in first}
    tail = [7, 11, 13, 17]

    def cached_now():
        return sum(e.stats["cached_tokens"] for e in engines(gw))

    def extend(origins):
        mark = cached_now()
        rids = [gw.submit(toks[o % len(toks)], streams[o] + tail,
                          max_new=GATEWAY_NEW, data_zone="public")
                for o in origins]
        gw.drain()
        return rids, cached_now() - mark
    together, cached_together = extend(first[2:])
    alone = {}
    for o in first[:2]:
        (rid,), cached = extend([o])
        alone[rid] = (o, cached)
    sync()
    wall = time.perf_counter() - t0
    m = gw.metrics()
    got = done_tokens("tiered", gw, list(first) + together + list(alone))
    want_together = sum(len(streams[o]) for o in first[2:])
    short_restore = [r for r, (o, cached) in alone.items()
                     if gw.jobs[r].restored_tokens != len(streams[o])
                     or cached != len(streams[o])]
    if not m["kv_restores"] or short_restore:
        raise AssertionError(f"gateway tiered: {m['kv_restores']} restores, "
                             f"jobs restored short {short_restore}: "
                             f"{alone}")
    row = report("5 tiered KV", gw, timer, wall,
                 sum(map(len, got.values())), direct["bf16"])
    row.update(demotions=m["kv_demotions"], restores=m["kv_restores"],
               restored_tokens=m["restored_tokens"],
               together_cached=cached_together,
               together_streams=want_together)
    results["tiered"] = row
    log_line(f"[gateway] 5: {m['kv_demotions']} demotions "
             f"({m['kv_demoted_bytes'] / 1e6:.1f} MB), {m['kv_restores']} "
             f"restores of {m['restored_tokens']} tokens; six extensions at "
             f"once served {cached_together} of their streams' "
             f"{want_together} tokens from cache (reported), two alone "
             f"served {[c for _, c in alone.values()]} tokens, their "
             f"streams' length exactly")
    del gw
    gc.collect()

    # 6. open loop into a StateStore
    timer = _EngineTimer(sync)
    gw, sec, toks = gateway(timer, {}, telemetry=True, idle_tick_s=0.05,
                            telemetry_flush_s=1.0)
    store = gw.telemetry_store
    tc = TrafficConfig(duration_s=5.0, base_rate_rps=4.0, tenants=2,
                       vocab_size=cfg.vocab_size, prefix_tokens=16,
                       interactive_max_new=8, batch_max_new=8, seed=0)
    trace = generate_trace(tc)
    t0 = time.perf_counter()
    run_open_loop(gw, toks, trace)
    gw.flush_telemetry()
    sync()
    wall = time.perf_counter() - t0
    m = gw.metrics()
    jobs = store.scan("servejob/")
    if m["completed"] + m["shed"] != len(trace) or len(jobs) != len(trace) \
            or gw.stats["telemetry_writes"] != store.write_count \
            or len(store.scan("audit/")) != len(sec.audit.records()) \
            or len(store.scan("metrics/")) != gw.stats["telemetry_flushes"] + 1:
        raise AssertionError(f"gateway open loop: {len(trace)} arrivals, "
                             f"{m['completed']} completed, {m['shed']} shed, "
                             f"{len(jobs)} job records, "
                             f"{gw.stats['telemetry_writes']} writes vs "
                             f"{store.write_count}")
    row = report(f"6 open loop, {len(trace)} arrivals over {tc.duration_s} s",
                 gw, timer, wall, m["tokens"], direct["bf16"])
    row.update(arrivals=len(trace), completed=m["completed"], shed=m["shed"],
               sla_rate=m["sla_rate"], telemetry_writes=store.write_count)
    results["open loop"] = row
    log_line(f"[gateway] 6: {len(trace)} arrivals, {m['completed']} "
             f"completed, {m['shed']} shed, SLA {m['sla_rate']:.3f}; "
             f"{store.write_count} StateStore writes "
             f"({m['statestore_throttled']} throttled)")
    del gw
    gc.collect()

    rates["ship_bytes_per_s"] = statistics.median(ship)
    rates.update(model_prefill_tok_s=svc.prefill_tok_per_s,
                 model_decode_step_s=svc.decode_step_s,
                 model_ship_bytes_per_s=svc.kv_ship_bytes_per_s)
    results["service_rates"] = rates
    log_line(f"[gateway] service rates measured through the bf16 fleet "
             f"(ServiceModel's in brackets): prefill "
             f"{rates['prefill_tok_s']:.0f} tok/s ({svc.prefill_tok_per_s:.0f})"
             f", {rates['decode_step_s'] * 1e3:.2f} ms a decode step "
             f"({svc.decode_step_s * 1e3:.0f}), ship (median of the four "
             f"evacuations) {rates['ship_bytes_per_s'] / 1e9:.2f} GB/s "
             f"({svc.kv_ship_bytes_per_s / 1e9:.0f})")
    return results


def phase_gateway(smi: str):
    """The Kotta serving gateway (``repro_torch.serve.gateway``) over
    full-width yi-6b engines (YI_CUT_LAYERS layers, bf16 weights from seed
    0, one tree for every replica; 8 slots, max_len 512, decode chunks of
    GATEWAY_CHUNK), the serve phase's 8 prompts over two tenants, 32 new
    tokens: an undisturbed two-replica fleet; a notice-window evacuation of
    the busier replica after its first chunk (bf16 and int8 pools, plain
    and spec); a notice too short to ship anything; disaggregated 1:1; a
    tiered KV store restoring a second wave; an open-loop trace into a
    StateStore."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import (launch_counts, launch_counts_by_route,
                                     reset_launch_counts)
    from repro_torch.models import get_family, init_params
    cfg = get_config("yi-6b").replace(num_layers=YI_CUT_LAYERS)
    params = init_params(cfg, get_family(cfg).layout(cfg), seed=0,
                         device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    direct = _direct_generates(cfg, params, "cuda", torch.cuda.synchronize)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = _gateway_scenarios(cfg, params, "cuda", torch.cuda.synchronize,
                                 log, direct)
    torch.cuda.synchronize()
    counts, by_route = launch_counts(), launch_counts_by_route()
    for kern in PAGED + ("rmsnorm_fused",):
        if counts[kern] <= 0:
            raise AssertionError(f"gateway: {kern} not launched {counts}")
    for kern in PAGED:
        if by_route[kern] != {"sm90": counts[kern], "cuda_core": 0}:
            raise AssertionError(f"gateway: a bf16 {kern} launch left the "
                                 f"sm90 route: {by_route[kern]}")
    peak = torch.cuda.max_memory_allocated()
    results["max_memory_allocated_bytes"] = peak
    log(f"[gateway] {time.perf_counter() - t0:.1f} s, launches {counts}, "
        f"paged by route {({k: by_route[k] for k in PAGED})}, peak device "
        f"memory {peak / 2**30:.2f} GiB, on {smi}")
    del params
    torch.cuda.empty_cache()
    return counts, results


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ---------------------------------------------------------------------------
# phase 8: training -- the backward kernels, f32 parity, full-width training
# ---------------------------------------------------------------------------

# internlm2-1.8b's training shape (configs/internlm2_1_8b.py): batch 8 x
# sequence 1024, 16 heads of 128 over 8 KV heads, d_model 2048.
TB, TS, TH, TKV, THD, TD = 8, 1024, 16, 8, 128, 2048
# The kernels' local shapes in phase 8c (b), internlm2-1.8b ``train_4k`` on
# rank 0 of the (16, 16) mesh: 16 rows of 4096, 1 query head over the 1 KV
# head it uses, hd 128, causal; RMSNorm over 16 x 4096 rows of 2048.
SHARD_LOCAL_FLASH = (16, 4096, 1, 1, 128, True)
SHARD_LOCAL_RMS = (16 * 4096, 2048)
# arctic-480b's in phase 8d (b): the 56 query heads over 8 KV heads stay
# whole on a 16-way "model" axis, hd 128, B 16, S 4096; RMSNorm over 16 x
# 4096 rows of 7168. The kernels are held to their plain versions at B 2
# (``ARCTIC_CHECK_FLASH``): the plain version's S x S scores at B 16 would
# take ~60 GB.
ARCTIC_LOCAL_FLASH = (16, 4096, 56, 8, 128, True)
ARCTIC_CHECK_FLASH = (2, 4096, 56, 8, 128, True)
ARCTIC_LOCAL_RMS = (16 * 4096, 7168)
TRAIN_STEPS, TRAIN_EVERY, TRAIN_REVOKE = 6, 3, 4
# The synthetic corpus both the train and the job phase read, under
# dataset/<TRAIN_CORPUS>/: 2 shards of 65,536 tokens from seed 0.
TRAIN_CORPUS, TRAIN_SHARDS = "train", dict(num_shards=2,
                                           tokens_per_shard=65_536, seed=0)
# Peak learning rate after 2 warm-up steps. Adam's first steps move every
# weight by about the learning rate, all at once: in this phase on the card
# the loss rose over the 6 steps at 1e-3 (11.83 -> 12.34, 15.24 at step 4)
# and fell with a bump at 1e-4 (11.30 at step 3, 11.82 at step 4).
TRAIN_LR = 3e-5


def _rel_err(got, want) -> float:
    """max|got - want| over max|want|, in f32."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def _flash_bwd_case(gen, dev, dtype, b, s, h, nkv, hd, causal=True):
    """(kernel, plain, inputs) of one flash-attention backward: the forward
    kernel's out and lse made once outside the timed call."""
    from repro_torch import kernels as K

    def rn(*shape):
        return (0.5 * torch_randn(gen, dev, *shape)).to(dtype)

    q, k, v = rn(b, s, h, hd), rn(b, s, nkv, hd), rn(b, s, nkv, hd)
    dout = rn(b, s, h, hd)
    out, lse = K.flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    return (lambda: K.flash_attention_bwd(q, k, v, out, dout, lse,
                                          causal=causal),
            lambda: K.attention_bwd_reference(q, k, v, dout, causal=causal),
            (q, k, v, dout))


def torch_randn(gen, dev, *shape):
    import torch
    return torch.randn(*shape, generator=gen, device=dev)


def _rms_bwd_case(gen, dev, dtype, rows, d, w_mean=1.0, w_std=0.1):
    from repro_torch import kernels as K
    x = torch_randn(gen, dev, rows, d).to(dtype)
    g = torch_randn(gen, dev, rows, d).to(dtype)
    w = w_mean + w_std * torch_randn(gen, dev, d)
    return (lambda: K.rmsnorm_bwd(x, w, g),
            lambda: K.rmsnorm_bwd_reference(x, w, g), (x, w, g))


def _sdpa_bwd(q, k, v, dout, causal=True):
    """Library yardstick: the backward of SDPA (flash backend where it
    takes the call) on (B,H,S,hd) copies, graph built outside the timed
    call; KV repeated beforehand where ``enable_gqa`` is absent."""
    import torch
    import torch.nn.functional as F
    qq, kk, vv = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    kw = {}
    g = q.shape[2] // k.shape[2]
    if g > 1:
        if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
            kw["enable_gqa"] = True
        else:
            kk, vv = (t.detach().repeat_interleave(g, dim=1).requires_grad_()
                      for t in (kk, vv))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal, **kw)
    gg = dout.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qq, kk, vv), gg,
                                       retain_graph=True)


def _bwd_twice(tag, name, label, route, kern, plain, tol=TOL_BF16):
    """A backward wrapper called twice against its plain version on the
    same inputs: both launches on ``route`` and no other launch, equal
    bits, each gradient within ``tol`` of its max |plain| -> the largest
    of those errors."""
    import torch
    from repro_torch import kernels as K
    K.reset_launch_counts()
    got, again = kern(), kern()
    torch.cuda.synchronize()
    routes = K.launch_counts_by_route()[name]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    errs = [_rel_err(a, b) for a, b in zip(got, plain())]
    ok = (routes.get(route) == 2 and sum(K.launch_counts().values()) == 2
          and same and all(math.isfinite(e) and e <= tol for e in errs))
    log(f"[{tag}] {name} {label}: max|kernel-plain|/max|plain| by gradient "
        f"{['%.2e' % e for e in errs]} (tol {tol}), repeat bitwise {same}, "
        f"routes {routes} (want 2 on {route}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} {name} {label}: errors {errs}, repeat "
                             f"equal {same}, routes {routes}")
    return max(errs)


def _rms_bwd_lib(x, w, g):
    import torch
    import torch.nn.functional as F
    xx = x.detach().requires_grad_()
    ww = w.to(x.dtype).detach().requires_grad_()
    out = F.rms_norm(xx, (x.shape[-1],), ww, 1e-6)
    return lambda: torch.autograd.grad(out, (xx, ww), g, retain_graph=True)


def _flash_bwd_bound(b, s, h, nkv, hd, dtype_bytes, causal=True):
    """(bytes, flops) of a flash-attention backward: q, k, v, out, dout and
    lse read once, dq, dk, dv written once; five products of 2 hd flops a
    visible (query, key) pair a head (S recomputed, dP, dV, dK, dQ)."""
    nbytes = (4 * b * s * h * hd + 4 * b * s * nkv * hd) * dtype_bytes \
        + 4 * b * h * s
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    return nbytes, 10.0 * hd * pairs


def _rms_bwd_bound(rows, d, dtype_bytes):
    """x and g read, dx written, w read and dw written (f32); ~8 flops an
    element."""
    return 3 * rows * d * dtype_bytes + 8 * d, 8.0 * rows * d


def _device_split(fn, calls: int = 10, tries: int = 3) -> dict:
    """{kernel name: device ms a call} of ``fn`` under ``torch.profiler``
    (the kernels' self device time over ``calls`` calls): where a wrapper's
    launches spend its time. A session that records no device activity
    (seen once late in a long run) is retried, up to ``tries`` sessions;
    after that the split is empty and the log says so."""
    import re
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    split = {}
    for attempt in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            m = re.search(r"(\w+_kernel)", e.key)
            name = m.group(1) if m else e.key[:60]
            split[name] = (split.get(name, 0.0)
                           + e.self_device_time_total / 1e3 / calls)
        if split:
            return split
        log(f"[profiler] session {attempt + 1} of {tries} recorded no device "
            f"activity")
    return split


def _bwd_timing(kern, plain, inputs, shape, dtype_bytes, lse_err=None):
    """A flash or RMSNorm backward timed beside its plain version, its
    library call and its bound, with each launch's device time: shape is
    (B, S, H, KV, hd, causal) for flash, (rows, D) for RMSNorm."""
    if len(shape) == 6:
        nbytes, flops = _flash_bwd_bound(*shape[:5], dtype_bytes,
                                         causal=shape[5])
        lib = _sdpa_bwd(*inputs, causal=shape[5])
    else:
        nbytes, flops = _rms_bwd_bound(*shape, dtype_bytes)
        lib = _rms_bwd_lib(*inputs)
    peak = BF16_FLOPS_PER_S if dtype_bytes == 2 else F32_FLOPS_PER_S
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / peak
    rec = dict(bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="bytes" if bytes_s >= ops_s else "operations",
               ms=time_ms(kern, iters=10),
               plain_ms=time_ms(plain, iters=3, warmup=1),
               library_ms=time_ms(lib, iters=10), shape=list(shape))
    rec["split_ms"] = _device_split(kern)
    if lse_err is not None:
        rec["lse_max_abs_err"] = lse_err
    return rec


def phase_backward_kernels():
    """The port's backward kernels against autograd of their plain
    versions on the same inputs, in bf16 (within TOL_BF16 of each
    gradient's max |value|) and f32 (TOL_F32): flash attention at
    internlm2-1.8b's training shape (B 8, S 1024, H 16, KV 8, hd 128,
    causal) and at hd 64, G 1 and 7, a ragged S of 1000 and non-causal,
    and at the frontends' training shapes (``FRONTEND_TRAIN_FLASH``:
    hubert-xlarge's B 8, S 1000, H = KV 16, hd 80, bidirectional, in bf16
    on the hd-128 kernels and in f32; paligemma-3b's B 8, S 512, H 8 over
    KV 1, hd 256, causal, in bf16; each with the forward's row
    log-sum-exp held to its plain version within 1e-3), each bf16 case on
    the tensor-core route and each f32 one on the CUDA-core route, and a
    bf16 hd 192 call, which must raise; RMSNorm at 8192 x 2048 and at D
    5120, 7168 and a ragged 1002 (scalar loads), each on the kernel of its
    D; in bf16, both at phase 8c (b)'s local shapes (``SHARD_LOCAL_FLASH``:
    B 16, S 4096, 1 head over 1, hd 128, causal; ``SHARD_LOCAL_RMS``: 65536
    x 2048) and at arctic-480b's of phase 8d (b) (``ARCTIC_CHECK_FLASH``:
    B 2, S 4096, 56 heads over 8, hd 128, causal; ``ARCTIC_LOCAL_RMS``:
    65536 x 7168), with their forward kernels held to the plain version
    there too (``_sharded_local_fwd``). Each twice, bit for bit the same (no
    atomics). The training shapes
    timed beside the plain version, the library's backward (SDPA,
    ``F.rms_norm``) and the bound (at the true hd), with each launch's
    device time (``torch.profiler``): internlm2-1.8b's in bf16, the
    frontends' in each dtype they run."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_path
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    flash_shapes = [("train", (TB, TS, TH, TKV, THD, True)),
                    ("hd64 G1", (2, 512, 8, 8, 64, True)),
                    ("G7", (2, 256, 7, 1, 128, True)),
                    ("ragged S 1000", (2, 1000, 4, 2, 128, True)),
                    ("non-causal", (2, 384, 4, 2, 64, False))]
    frontend = dict(FRONTEND_TRAIN_FLASH)
    rms_shapes = [("train", (TB * TS, TD)), ("D 5120", (512, 5120)),
                  ("D 7168", (512, 7168)), ("ragged D 1002", (64, 1002))]
    results = {"flash_attention_bwd": {}, "rmsnorm_bwd": {}}
    for dtype, tol, kind in ((torch.bfloat16, TOL_BF16, "bf16"),
                             (torch.float32, TOL_F32, "f32")):
        # The frontends' f32 case is hubert's hd 80; f32 at hd 256 runs in
        # paligemma-3b's train parity (phase_train_parity). The sharded
        # step's local shapes run in bf16 alone, as phase 8c (b) does.
        bf16 = kind == "bf16"
        fshapes = flash_shapes + [
            (label, shape) for label, shape in frontend.items()
            if bf16 or label == "hubert-xlarge"] + (
            [("sharded local", SHARD_LOCAL_FLASH),
             ("arctic local", ARCTIC_CHECK_FLASH)] if bf16 else [])
        rshapes = rms_shapes + ([("sharded local", SHARD_LOCAL_RMS),
                                 ("arctic local", ARCTIC_LOCAL_RMS)]
                                if bf16 else [])
        cases = ([("flash_attention_bwd", label,
                   _flash_bwd_case(gen, dev, dtype, *shape), shape)
                  for label, shape in fshapes]
                 + [("rmsnorm_bwd", label, _rms_bwd_case(gen, dev, dtype,
                                                         *shape), shape)
                    for label, shape in rshapes])
        for name, label, (kern, plain, inputs), shape in cases:
            K.reset_launch_counts()
            got, again = kern(), kern()
            torch.cuda.synchronize()
            routes = K.launch_counts_by_route()[name]
            if name == "flash_attention_bwd":
                want = "sm90" if kind == "bf16" else "cuda_core"
            else:
                want = rmsnorm_path(shape[1], dtype)
            if routes[want] != 2 or sum(routes.values()) != 2:
                raise AssertionError(f"{name} {kind} {label}: launches by "
                                     f"route {routes}, want 2 on {want}")
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            errs = [_rel_err(a, b) for a, b in zip(got, plain())]
            err = max(errs)
            ok = same and math.isfinite(err) and err <= tol
            log(f"[kernels] {name} {kind} {label} {shape} on {want}: "
                f"max|kernel-plain|/max|plain| by gradient "
                f"{['%.2e' % e for e in errs]} (tol {tol}), repeat bitwise "
                f"{same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {kind} {label} disagrees: "
                                     f"{errs}, repeat equal {same}")
            rec = results[name].setdefault(kind, {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            nbytes = 2 if kind == "bf16" else 4
            if label in ("sharded local", "arctic local"):
                rec[label.replace(" ", "_")] = {
                    "shape": shape, "bwd_max_rel_err": err,
                    **_sharded_local_fwd(name, inputs, shape)}
                continue
            if name == "flash_attention_bwd" and label in frontend:
                q, k, v, _ = inputs
                _, lse = K.flash_attention_fwd(q, k, v, causal=shape[5],
                                               return_lse=True)
                lse_err = (lse - K.attention_lse_reference(
                    q, k, v, causal=shape[5])).abs().max().item()
                if not lse_err <= 1e-3:
                    raise AssertionError(f"flash forward {kind} {label}: "
                                         f"lse off by {lse_err}")
                fr = rec.setdefault("frontend_shapes", {})
                fr[label] = _bwd_timing(kern, plain, inputs, shape, nbytes,
                                        lse_err)
                fr[label]["max_rel_err"] = err
                r = fr[label]
            elif kind == "bf16" and label == "train":
                rec.update(_bwd_timing(kern, plain, inputs, shape, nbytes))
                r = rec
            else:
                continue
            log(f"[kernels] {name} {kind} {label} {shape}: kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}); device ms a call by launch (profiler) "
                f"{ {k: round(v, 4) for k, v in r['split_ms'].items()} }"
                + (f"; forward lse max|kernel-plain| "
                   f"{r['lse_max_abs_err']:.2e}" if "lse_max_abs_err" in r
                   else ""))
        del cases
        torch.cuda.empty_cache()
    # Off the tensor-core contract: a bf16 hd 192 backward raises before
    # any launch and is never rerouted to the CUDA-core kernel.
    K.reset_launch_counts()
    kern, _, _ = _flash_bwd_case(gen, dev, torch.bfloat16, 1, 128, 2, 1, 192)
    try:
        kern()
    except ValueError as e:
        log(f"[kernels] flash_attention_bwd bf16 hd 192 raises: {e}")
    else:
        raise AssertionError("flash_attention_bwd bf16 hd 192 did not raise")
    if K.launch_counts()["flash_attention_bwd"]:
        raise AssertionError("flash_attention_bwd bf16 hd 192 launched")
    return results


def _sharded_local_fwd(name, inputs, shape) -> dict:
    """The forward kernel of a backward case at the sharded step's local
    shape (``SHARD_LOCAL_FLASH``, ``SHARD_LOCAL_RMS``), once, against its
    plain version on the same inputs: max|kernel - plain| over max|plain|
    within TOL_BF16 (the flash forward's row log-sum-exp within 1e-3
    absolute), one launch, the flash one on sm90."""
    import torch
    from repro_torch import kernels as K
    K.reset_launch_counts()
    if name == "flash_attention_bwd":
        q, k, v, _ = inputs
        causal = shape[5]
        fwd = "flash_attention_fwd"
        out, lse = K.flash_attention_fwd(q, k, v, causal=causal,
                                         return_lse=True)
        torch.cuda.synchronize()
        routed = K.launch_counts_by_route()[fwd]["sm90"] == 1
        errs = {"fwd_max_rel_err": _rel_err(out, K.attention_reference(
                    q, k, v, causal=causal)),
                "lse_max_abs_err": (lse - K.attention_lse_reference(
                    q, k, v, causal=causal)).abs().max().item()}
        ok = errs["lse_max_abs_err"] <= 1e-3
    else:
        x, w, _ = inputs
        fwd, routed, ok = "rmsnorm_fused", True, True
        out = K.rmsnorm_fused(x, w)
        torch.cuda.synchronize()
        errs = {"fwd_max_rel_err": _rel_err(out, K.rmsnorm_reference(x, w))}
    launches = sum(K.launch_counts().values())
    ok = (ok and routed and launches == 1 and math.isfinite(
        errs["fwd_max_rel_err"]) and errs["fwd_max_rel_err"] <= TOL_BF16)
    log(f"[kernels] {fwd} bf16 sharded local {shape}: "
        f"{ {k: '%.2e' % v for k, v in errs.items()} } (tol {TOL_BF16}"
        f"{'; lse 1e-3' if 'lse_max_abs_err' in errs else ''}), {launches} "
        f"launch{'' if routed else ' off sm90'} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{fwd} at the sharded local shape {shape}: "
                             f"{errs}, {launches} launches, routed {routed}")
    return errs


def _train_grads(fam, cfg, params, batch):
    import torch
    from repro_torch.train import adamw
    leaves = adamw.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = fam.train_loss(cfg, params, batch)
    # a leaf the loss does not reach (hubert's token embedding) gets zeros,
    # as the train step gives it
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def _parity_batch(cfg, rng):
    """(numpy batch, its description) of the train parity at B 2: tokens and
    labels over ZS positions; a frame frontend's ZS frames with labels and
    a Bernoulli(0.3) ``loss_mask``; a patch frontend's ``frontend_len``
    patches before 64 text tokens (one chunk of any ``logit_chunk`` from
    64 up)."""
    import numpy as np

    def ints(*shape):
        return rng.integers(0, cfg.vocab_size, shape).astype(np.int64)

    if cfg.frontend == "frame":
        return ({"frames": rng.standard_normal((2, ZS, cfg.frontend_dim),
                                               dtype=np.float32),
                 "labels": ints(2, ZS),
                 "loss_mask": (rng.random((2, ZS)) < 0.3).astype(
                     np.float32)}, f"B 2 x {ZS} frames")
    if cfg.frontend == "patch":
        p = cfg.frontend_len
        return ({"patches": rng.standard_normal((2, p, cfg.frontend_dim),
                                                dtype=np.float32),
                 "tokens": ints(2, 64), "labels": ints(2, 64)},
                f"B 2 x ({p} patches + 64 tokens)")
    return {"tokens": ints(2, ZS), "labels": ints(2, ZS)}, f"B 2, S {ZS}"


def _train_parity(cfg, label, kernels=("flash_attention_fwd",
                                        "flash_attention_bwd",
                                        "rmsnorm_fused", "rmsnorm_bwd"),
                  want=None):
    """``train_loss`` and every gradient at ``cfg`` (f32, depth 2, B 2, S
    256; a frame frontend's 256 frames, a patch frontend's patches before
    64 text tokens: ``_parity_batch``) on the card (kernels, backward
    kernels) against the CPU (plain versions, autograd) from the same
    weights; each of ``kernels``
    launched at least once a layer, or, given ``want``, every kernel's
    launches exactly those (the others none). The loss within 1e-5; of the
    CPU's loss where that is above 128, whose f32 ulp exceeds 1e-5. Every
    f32 launch on its CUDA-core route."""
    import numpy as np
    import torch
    from repro_torch.kernels import (launch_counts, launch_counts_by_route,
                                     reset_launch_counts)
    from repro_torch.models import get_family, init_params
    fam = get_family(cfg)
    gpu = init_params(cfg, fam.layout(cfg), seed=0, device="cuda",
                      dtype=torch.float32)
    cpu = _to(gpu, "cpu")
    batch, shape = _parity_batch(cfg, np.random.default_rng(2))
    reset_launch_counts()
    gl, gg = _train_grads(fam, cfg, gpu, {k: torch.from_numpy(v).cuda()
                                          for k, v in batch.items()})
    torch.cuda.synchronize()
    counts, routes = launch_counts(), launch_counts_by_route()
    cl, cg = _train_grads(fam, cfg, cpu, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    relative = abs(cl.item()) > 128
    loss_err = abs(gl.item() - cl.item()) / (abs(cl.item()) if relative
                                             else 1.0)
    grad_err = max(_rel_err(a.cpu(), b) for a, b in zip(gg, cg))
    log(f"[train parity] {label} widths, {cfg.num_layers} layers, f32, "
        f"{shape}: loss card {gl.item():.6f} cpu {cl.item():.6f} "
        f"(|diff|{' / |cpu|' if relative else ''} {loss_err:.2e}, "
        f"tol 1e-5), max gradient error / leaf max "
        f"{grad_err:.2e} (tol 1e-4) over {len(cg)} leaves, launches "
        f"{counts}")
    if not (loss_err <= 1e-5 and grad_err <= 1e-4):
        raise AssertionError(f"train parity {label}: loss {loss_err}, "
                             f"grads {grad_err}")
    if want is not None:
        if {k: v for k, v in counts.items() if v} != want:
            raise AssertionError(f"train parity {label}: launches {counts}, "
                                 f"want {want}")
    elif any(counts[name] < cfg.num_layers for name in kernels):
        raise AssertionError(f"train parity {label} missed one of {kernels}:"
                             f" {counts}")
    if any(routes[k]["sm90"] for k in ("flash_attention_fwd",
                                       "flash_attention_bwd", "ssd_scan")):
        raise AssertionError(f"f32 left the CUDA-core route: {routes}")
    del gpu, cpu, gg, cg
    torch.cuda.empty_cache()


def phase_train_parity():
    """internlm2-1.8b widths, olmoe-1b-7b widths (the MoE aux losses) and
    the frontends' (hubert-xlarge: frames, a loss mask, bidirectional
    attention at hd 80; paligemma-3b: patches before the text, MQA at hd
    256, its 257,216-token tied vocabulary) at depth 2 in f32, card against
    CPU: the f32 flash backward at hd 80 and 256 on the CUDA-core route."""
    from repro_torch.configs import get_config
    for name in ("internlm2-1.8b", "olmoe-1b-7b", "hubert-xlarge",
                 "paligemma-3b"):
        _train_parity(get_config(name).replace(num_layers=2, dtype="float32"),
                      name)


class _StepProbe:
    """Wraps the trainer's step: per step, the wall time (synchronized) and
    the kernels' launches in it, counts read just before and just after
    (their difference), so a caller may also count a whole run."""

    def __init__(self, fn):
        self.fn = fn
        self.steps = []
        self.windows = []               # (start, end) on the host's clock

    def __call__(self, params, opt_state, batch):
        import torch
        from repro_torch import kernels as K
        torch.cuda.synchronize()
        counts, routes = K.launch_counts(), K.launch_counts_by_route()
        t0 = time.perf_counter()
        out = self.fn(params, opt_state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.windows.append((t0, t0 + dt))
        self.steps.append((
            dt, {k: v - counts[k] for k, v in K.launch_counts().items()},
            {k: {r: n - routes[k][r] for r, n in by.items()}
             for k, by in K.launch_counts_by_route().items()}))
        return out


def _run_launches(probe) -> dict:
    """Each kernel's launches summed over a probed run's steps."""
    total = {}
    for _, counts, _ in probe.steps:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


class _GpuSampler:
    """The card's SM clock (MHz), power draw (W) and temperature (C) from
    ``nvidia-smi`` every 200 ms, each sample stamped with the host's clock
    on arrival: a context manager that starts one ``nvidia-smi`` process
    and a thread reading it, and stops both on exit."""

    def __enter__(self):
        import threading
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                sm, watts, temp = (float(x) for x in line.split(","))
            except ValueError:
                continue
            self.samples.append((time.perf_counter(), sm, watts, temp))

    def __exit__(self, *exc):
        self.proc.terminate()
        self.proc.wait(timeout=10)
        self.reader.join(timeout=10)

    def during(self, windows) -> dict:
        """Each window's median SM clock (None where no sample fell in it),
        and over all windows the median SM clock and power and the highest
        temperature."""
        import statistics as st
        inside = [[x for x in self.samples if a <= x[0] <= b]
                  for a, b in windows]
        every = [x for w in inside for x in w]
        if not every:
            return {"samples": 0}
        return {"samples": len(every),
                "sm_mhz_per_step": [st.median(x[1] for x in w) if w else None
                                    for w in inside],
                "sm_mhz": st.median(x[1] for x in every),
                "power_w": st.median(x[2] for x in every),
                "temp_c_max": max(x[3] for x in every)}


def _timed_checkpointer(store, run, keep_last=None):
    """A Checkpointer whose saves and restores are timed (synchronized)."""
    import torch
    from repro_torch.checkpoint import Checkpointer

    class Timed(Checkpointer):
        events = []

        def save(self, step, tree, blocking=True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().save(step, tree, blocking)
            self.events.append(("save", step, time.perf_counter() - t0,
                                _tree_bytes(tree)))

        def restore(self, like, step=None):
            t0 = time.perf_counter()
            out = super().restore(like, step)
            torch.cuda.synchronize()
            self.events.append(("restore", out[0], time.perf_counter() - t0,
                                _tree_bytes(out[1])))
            return out

    ck = Timed(store, run, keep_last=keep_last)
    ck.events = []
    return ck


def _tree_bytes(tree) -> int:
    from repro_torch.checkpoint.checkpointer import _flatten
    return sum(t.numel() * t.element_size() for _, t in _flatten(tree))


def _plain_call_counter():
    """Count calls of the plain versions behind the ops entries, so a run
    can show that no backward on the card went through one."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.rmsnorm import ops as rops
    calls = {"attention_reference": 0, "rmsnorm_reference": 0,
             "ssd_chunked_reference": 0}

    def wrap(mod, name):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        setattr(mod, name, counted)
        return lambda: setattr(mod, name, fn)

    undo = [wrap(fops, "attention_reference"), wrap(rops, "rmsnorm_reference"),
            wrap(sops, "ssd_chunked_reference")]
    return calls, lambda: [u() for u in undo]


def _corpus_source(store, cfg, batch, seq):
    """Token batches (``TokenLoader``, seed 0) over the synthetic corpus
    that the train and job phases read, built in ``store`` at ``cfg``'s
    vocabulary."""
    from repro_torch.data import SyntheticCorpus, TokenLoader
    keys = SyntheticCorpus.build(store, TRAIN_CORPUS, **TRAIN_SHARDS,
                                 vocab_size=cfg.vocab_size)
    return TokenLoader(store.get, keys, batch_size=batch, seq_len=seq,
                       seed=0)


class _FrameBatches:
    """hubert-xlarge's training batches, a pure function of the step (so a
    restart replays them): ``batch`` x ``seq`` frames of standard normal
    ``frontend_dim`` features from (seed, step), labelled with HuBERT's kind
    of target, the index of the nearest of ``vocab_size`` fixed random
    centroids (from ``seed``), and a ``loss_mask`` drawn Bernoulli(0.3), the
    reference's tests' rate."""

    def __init__(self, cfg, batch, seq, seed=0):
        import numpy as np
        self.shape, self.seed = (batch, seq, cfg.frontend_dim), seed
        self.centroids = np.random.default_rng(seed).standard_normal(
            (cfg.vocab_size, cfg.frontend_dim), dtype=np.float32)

    def batch_at(self, step):
        import numpy as np
        rng = np.random.default_rng((self.seed, step))
        frames = rng.standard_normal(self.shape, dtype=np.float32)
        c = self.centroids
        # argmin_c |x - c|^2 = argmin_c |c|^2 - 2 x.c
        labels = ((c * c).sum(-1) - 2.0 * (frames @ c.T)).argmin(-1)
        mask = rng.random(self.shape[:2]) < 0.3
        return {"frames": frames, "labels": labels.astype(np.int32),
                "loss_mask": mask.astype(np.float32)}


class _PatchBatches:
    """paligemma-3b's training batches: each step's text from ``text`` (a
    ``TokenLoader``) after ``frontend_len`` standard normal patch
    embeddings from (seed, step)."""

    def __init__(self, text, cfg, batch, seed=0):
        self.text, self.seed = text, seed
        self.shape = (batch, cfg.frontend_len, cfg.frontend_dim)

    def batch_at(self, step):
        import numpy as np
        rng = np.random.default_rng((self.seed, step))
        return {**self.text.batch_at(step),
                "patches": rng.standard_normal(self.shape, dtype=np.float32)}


def _train_run(cfg, opt, revoke: bool, *, batch=TB, seq=TS,
               steps=TRAIN_STEPS, every=TRAIN_EVERY,
               revoke_step=TRAIN_REVOKE, source=_corpus_source):
    """One ElasticTrainer run of ``steps`` steps on a fresh store, batch x
    seq from ``source(store, cfg, batch, seq)`` (an object with
    ``batch_at(step)``), checkpoints every ``every`` steps (the latest
    kept: a restart restores only it, and paligemma-3b's state is ~15 GB
    of host memory a copy), revoked once at ``revoke_step`` if ``revoke``;
    returns (trainer, report, probe, checkpoint events)."""
    from repro_torch.core import ObjectStore, VirtualClock
    from repro_torch.train import ElasticTrainer
    store = ObjectStore(clock=VirtualClock())
    loader = source(store, cfg, batch, seq)
    ck = _timed_checkpointer(store, "revoked" if revoke else "plain",
                             keep_last=1)
    trainer = ElasticTrainer(cfg, opt, ck, seed=0, device="cuda")
    probe = _StepProbe(trainer._step_fn)
    trainer._step_fn = probe
    fired = []

    def revoke_at(step):
        if revoke and step == revoke_step and not fired:
            fired.append(step)
            return True
        return False

    rep = trainer.train(loader, steps, checkpoint_every=every,
                        revoke_at=revoke_at)
    return trainer, rep, probe, ck.events


def _transformer_step_launches(cfg):
    """A dense transformer's training step with remat "full", bf16: each
    layer's flash forward and two norms run again in its recompute, and
    ``final_norm`` once -> (launches, launches by route): flash forward 2L
    and backward L, all on sm90; RMSNorm forward 4L + 1 and backward 2L + 1
    on its register kernel."""
    L = cfg.num_layers
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd": L,
            "rmsnorm_fused": 4 * L + 1, "rmsnorm_bwd": 2 * L + 1}
    return want, {
        "flash_attention_fwd": {"sm90": 2 * L, "cuda_core": 0},
        "flash_attention_bwd": {"sm90": L, "cuda_core": 0},
        "rmsnorm_bwd": {"registers": 2 * L + 1, "smem": 0}}


def _train_opt():
    """The train phase's AdamW: int8 moments, a short warm-up."""
    from repro_torch.train import AdamWConfig
    return AdamWConfig(learning_rate=TRAIN_LR, warmup_steps=2,
                       decay_steps=100, state_dtype="int8")


def phase_train(smi: str):
    """Full-width, full-depth internlm2-1.8b (24 layers, bf16 compute over
    f32 master weights, remat "full", seed 0) trained by ``ElasticTrainer``
    on a ``SyntheticCorpus`` in the port's ``ObjectStore``, batch 8 x 1024,
    AdamW with int8 moments, 6 steps with checkpoints every 3: once
    uninterrupted (timed), once revoked at step 4 and resumed from the
    step-3 checkpoint. Under ``torch.use_deterministic_algorithms``; the
    two runs' final parameters and optimizer state are held bit for bit
    equal, the loss at step 6 below step 1's, and every step's launches
    exactly to the code's: flash forward 2L (forward and remat recompute,
    all on sm90), flash backward L, RMSNorm forward 4L + 1 and backward
    2L + 1, nothing else; no plain version called."""
    import statistics as st
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import count_params
    from repro_torch.train.adamw import tree_leaves
    cfg = get_config("internlm2-1.8b")
    assert cfg.remat == "full" and cfg.param_dtype == "float32"
    opt = _train_opt()
    L = cfg.num_layers
    want, want_routes = _transformer_step_launches(cfg)
    plain_calls, undo = _plain_call_counter()
    torch.use_deterministic_algorithms(True)
    try:
        # Earlier phases' tensors held only by reference cycles would count
        # in the peak: collect them first, and report what is left.
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with _GpuSampler() as gpu:
            t0 = time.perf_counter()
            ref, ref_rep, ref_probe, ref_ck = _train_run(cfg, opt,
                                                         revoke=False)
            peak = torch.cuda.max_memory_allocated()
            ref_wall = time.perf_counter() - t0
            ref_final = [t.detach() for t in _state_leaves(ref.final_state)]
            t1 = time.perf_counter()
            digest = _state_digest(ref.final_state)
            digest_s = time.perf_counter() - t1
            del ref
            gc.collect()
            torch.cuda.empty_cache()
            rev, rev_rep, rev_probe, rev_ck = _train_run(cfg, opt,
                                                         revoke=True)
            rev_final = [t.detach() for t in _state_leaves(rev.final_state)]
            del rev
            gc.collect()
    finally:
        torch.use_deterministic_algorithms(False)
        undo()
    bitwise = (len(ref_final) == len(rev_final)
               and all(torch.equal(a, b) for a, b in zip(ref_final,
                                                          rev_final)))
    step_s = [dt for dt, _, _ in ref_probe.steps]
    rev_step_s = [dt for dt, _, _ in rev_probe.steps]
    steady = st.median(step_s[1:])
    clocks = {"uninterrupted": gpu.during(ref_probe.windows),
              "revoked": gpu.during(rev_probe.windows)}
    saves = [e for e in ref_ck + rev_ck if e[0] == "save"]
    restores = [e for e in rev_ck if e[0] == "restore"]
    gb = saves[0][3] / 1e9
    rec = {
        "config": "internlm2-1.8b", "layers": L, "params": count_params(cfg),
        "batch": TB, "seq": TS, "steps": TRAIN_STEPS,
        "state_dtype": "int8", "losses": {str(k): v for k, v in
                                          ref_rep.losses.items()},
        "step_ms": [s * 1e3 for s in step_s],
        "step_ms_median_after_first": steady * 1e3,
        "revoked_run_step_ms": [s * 1e3 for s in rev_step_s],
        "gpu_during_steps": clocks,
        "tokens_per_s": TB * TS / steady,
        "max_memory_allocated_bytes": peak,
        "allocated_before_bytes": held,
        "uninterrupted_run_s": ref_wall,
        "checkpoint_gb": gb,
        "save_s": [e[2] for e in saves],
        "save_gb_per_s": [e[3] / 1e9 / e[2] for e in saves],
        "restore_s": [e[2] for e in restores],
        "restore_gb_per_s": [e[3] / 1e9 / e[2] for e in restores],
        "launches_per_step": want,
        "launches_by_route_per_step": want_routes,
        "launches": _run_launches(ref_probe),
        "launches_by_route": {
            k: {r: sum(step[2][k][r] for step in ref_probe.steps)
                for r in by} for k, by in want_routes.items()},
        "bitwise_restart": bitwise,
        "state_sha256": digest, "digest_s": digest_s}
    log(f"[train] internlm2-1.8b {L} layers ({rec['params'] / 1e9:.3f} B "
        f"params), bf16 over f32 masters, remat full, int8 moments, B {TB} "
        f"x S {TS}: losses {[round(x, 4) for x in ref_rep.losses.values()]}; "
        f"step ms {[round(x * 1e3, 1) for x in step_s]} (median after the "
        f"first {steady * 1e3:.1f} ms = {rec['tokens_per_s']:.0f} tokens/s);"
        f" peak device memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB "
        f"held before the run); checkpoint "
        f"{gb:.2f} GB: saves {[round(e[2], 2) for e in saves]} s "
        f"({[round(x, 2) for x in rec['save_gb_per_s']]} GB/s), restore "
        f"{[round(e[2], 2) for e in restores]} s "
        f"({[round(x, 2) for x in rec['restore_gb_per_s']]} GB/s); revoked "
        f"at step {TRAIN_REVOKE}, resumed from step {TRAIN_EVERY}: final "
        f"params and optimizer state bit for bit equal: {bitwise} "
        f"({len(ref_final)} tensors); launches a step {want}; the revoked "
        f"run's step ms {[round(x * 1e3, 1) for x in rev_step_s]}; "
        f"{_clock_text(clocks)}; on {smi}")
    for label, rep, probe in (("uninterrupted", ref_rep, ref_probe),
                              ("revoked", rev_rep, rev_probe)):
        for i, (_, counts, routes) in enumerate(probe.steps):
            got = {k: v for k, v in counts.items() if v}
            if got != want or any(routes[k] != v
                                  for k, v in want_routes.items()):
                raise AssertionError(f"train {label} step {i + 1}: launches "
                                     f"{got} routes {routes}, want {want}")
        if not rep.losses[TRAIN_STEPS] < rep.losses[1]:
            raise AssertionError(f"train {label}: loss did not fall "
                                 f"{rep.losses}")
    if sum(plain_calls.values()):
        raise AssertionError(f"train: a plain version ran on the card: "
                             f"{plain_calls}")
    if rev_rep.restarts != 1 or rev_rep.steps_run != TRAIN_STEPS + 1 \
            or not bitwise:
        raise AssertionError("train: the revoked run's final state is not "
                             "bit for bit the uninterrupted run's")
    if rev_rep.losses[TRAIN_STEPS] != ref_rep.losses[TRAIN_STEPS]:
        raise AssertionError(f"train: final losses differ "
                             f"{rev_rep.losses} {ref_rep.losses}")
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 8b: the launch layer's dry-run against the measured training step
# ---------------------------------------------------------------------------

#: The dry-run's bytes a device against the train phase's peak: 3%. The
#: readings were -0.2% and -0.0% on the H100; leaving out a whole class of
#: state (the f32 gradients, ~22% of internlm2's peak, or the int8
#: moments, ~11%) would fail it.
LAUNCH_MEMORY_TOL = 0.03


def phase_launch(smi: str, train: dict):
    """The dry-run of the train phase's cell (internlm2-1.8b, B ``TB`` x S
    ``TS``, the card mesh, int8 moments) beside that phase's measured
    step; fails if the predicted bytes a device are more than
    ``LAUNCH_MEMORY_TOL`` off the run's peak device memory, or if the
    trace touched the card (an op on a CUDA tensor, a kernel launch, a
    byte allocated). Host tensors may take part (a scalar made on the CPU
    before it reaches the meta device)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.cost import H100_SXM
    from repro_torch.launch.dryrun import analyze_cell
    cfg = get_config("internlm2-1.8b")
    shape = ShapeConfig("train_8x1k", "train", TS, TB)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rec = analyze_cell(cfg, shape, "card", opt_cfg=_train_opt())
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    touched = torch.cuda.memory_allocated() - allocated
    mem, roof, hlo = rec["memory"], rec["roofline"], rec["hlo"]
    predicted = mem["per_device_total"]
    # the run's own peak: what earlier phases left allocated is not its
    measured = train["max_memory_allocated_bytes"] \
        - train["allocated_before_bytes"]
    step_s = train["step_ms_median_after_first"] / 1e3
    terms = {k: roof[k] for k in ("compute_s", "memory_s", "collective_s")}
    total = torch.cuda.get_device_properties(0).total_memory
    out = {
        "cell": {"arch": cfg.name, "shape": dataclasses.asdict(shape),
                 "mesh": "card", "state_dtype": "int8"},
        "trace_s": rec["trace_s"], "phase_s": wall,
        "predicted_per_device_bytes": predicted,
        "measured_peak_bytes": measured,
        "max_memory_allocated_bytes": train["max_memory_allocated_bytes"],
        "allocated_before_bytes": train["allocated_before_bytes"],
        "memory_rel_err": predicted / measured - 1.0,
        "memory": mem, "dot_flops": hlo["dot_flops"],
        "model_flops": roof["model_flops"],
        "useful_flops_ratio": roof["useful_flops_ratio"],
        "kernel_regions": hlo["kernel_regions"],
        "roofline_terms_s": terms, "memory_fused_s": roof["memory_fused_s"],
        "bottleneck": roof["bottleneck"],
        "roofline_s": max(terms.values()),
        "roofline_fraction": roof["roofline_fraction"],
        "model_time_s": roof["model_time_s"],
        "measured_step_s": step_s,
        "measured_share_of_peak": roof["model_time_s"] / step_s,
        "spec": dataclasses.asdict(H100_SXM),
        "card_total_memory_bytes": total, "card": smi,
        "devices_seen": hlo["devices_seen"], "launches": launched,
        "bytes_allocated_on_card": touched}
    log(f"[launch] dry-run of internlm2-1.8b train B {TB} x S {TS} (card "
        f"mesh, int8 moments, traced on meta in {rec['trace_s']:.2f} s): "
        f"predicted {predicted / 2**30:.2f} GiB a device vs the train "
        f"phase's peak {measured / 2**30:.2f} GiB "
        f"(max_memory_allocated {out['max_memory_allocated_bytes'] / 2**30:.2f}"
        f" GiB, {out['allocated_before_bytes'] / 2**30:.2f} held before; "
        f"{out['memory_rel_err'] * 100:+.1f}%); dot FLOPs "
        f"{hlo['dot_flops']:.4e} vs model FLOPs {roof['model_flops']:.4e} "
        f"(useful ratio {roof['useful_flops_ratio']:.3f}); roofline "
        f"compute {terms['compute_s'] * 1e3:.1f} / memory "
        f"{terms['memory_s'] * 1e3:.1f} (fused "
        f"{roof['memory_fused_s'] * 1e3:.1f}) / collective "
        f"{terms['collective_s'] * 1e3:.1f} ms, bound "
        f"{out['roofline_s'] * 1e3:.1f} ms ({roof['bottleneck']}) vs the "
        f"measured step {step_s * 1e3:.1f} ms; model time "
        f"{roof['model_time_s'] * 1e3:.1f} ms: measured share of peak "
        f"{out['measured_share_of_peak']:.4f}; H100_SXM.hbm_bytes "
        f"{H100_SXM.hbm_bytes:.4e} vs the card's total_memory {total:.4e}; "
        f"on {smi}")
    if "cuda" in hlo["devices_seen"] or launched or touched:
        raise AssertionError(f"launch: the meta trace touched the card: "
                             f"devices {hlo['devices_seen']}, launches "
                             f"{launched}, {touched} bytes allocated")
    if abs(out["memory_rel_err"]) > LAUNCH_MEMORY_TOL:
        raise AssertionError(f"launch: predicted {predicted} bytes, the "
                             f"train phase's peak {measured}: more than "
                             f"{LAUNCH_MEMORY_TOL:.0%} apart")
    return out


# ---------------------------------------------------------------------------
# phase 8c: sharding -- the sharded train step on a (1, 1) mesh and on rank
# 0 of the production mesh
# ---------------------------------------------------------------------------

#: (a): internlm2-1.8b steps on the one-process (1, 1) mesh, each run.
SHARD_STEPS = 3
#: (b): the production cell's steps on rank 0 of the (16, 16) mesh.
SHARD_PROD_STEPS = 2


def _shard_batches(cfg, n, batch, seq, seed, dtype=None):
    """``n`` token batches (tokens, labels) of batch x seq on the card from
    a CUDA generator (``dtype``: the index dtype, default int64)."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    kw = {} if dtype is None else {"dtype": dtype}
    return [{k: torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                              device="cuda", **kw)
             for k in ("tokens", "labels")} for _ in range(n)]


def _probe_launches(label, probe, want, want_routes):
    """Every probed step's launches exactly ``want``, and ``want_routes``'
    counts by route."""
    for i, (_, counts, routes) in enumerate(probe.steps):
        got = {k: v for k, v in counts.items() if v}
        if got != want or any(routes[k] != v for k, v in want_routes.items()):
            raise AssertionError(f"sharding {label} step {i + 1}: launches "
                                 f"{got} routes {routes}, want {want} "
                                 f"{want_routes}")


def _sharded_one_rank(smi, cfg=None, tag="sharding", launches=None,
                      batch=TB, seq=TS, part="a"):
    """(a) internlm2-1.8b (or ``cfg``) at full width and depth, bf16 over
    f32 masters, remat full, the train phase's AdamW (int8 moments), B
    ``batch`` x S ``seq``, ``SHARD_STEPS`` steps under deterministic
    algorithms: once the
    replicated ``build_train_step`` with no rules, once through
    ``shard_params`` and ``build_train_step(..., sharded=True)`` on a
    one-process NCCL group's (1, 1) ("data", "model") mesh, every
    collective issued over its one rank. The losses and metrics of every
    step and the final parameters (``gather_params``) equal bit for bit;
    every sharded step's launches exactly the train phase's (``launches``:
    (launches, by route) a step, default ``_transformer_step_launches``),
    every bf16 one on sm90; no plain version called. ``part``: the
    check's letter in the log and the errors."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import ShardingRules, activate_rules
    from repro_torch.distributed.sharding import gather_params, shard_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_family, init_params
    from repro_torch.models.params import tree_map_specs
    from repro_torch.train import adamw, build_train_step
    cfg = cfg or get_config("internlm2-1.8b")
    layout = get_family(cfg).layout(cfg)
    opt = _train_opt()
    want, want_routes = launches or _transformer_step_launches(cfg)
    batches = _shard_batches(cfg, SHARD_STEPS, batch, seq, seed=2)
    base = init_params(cfg, layout, seed=0, device="cuda",
                       dtype=torch.float32)
    for p in adamw.tree_leaves(base):
        p.requires_grad_(True)
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    plain_calls, undo = _plain_call_counter()
    torch.use_deterministic_algorithms(True)
    runs = {}
    try:
        rules = ShardingRules(mesh)
        shards = shard_params(base, layout, rules)
        for label in ("replicated", "sharded"):
            sharded = label == "sharded"
            params = shards if sharded else base
            state = adamw.init(opt, params, tree_map_specs(
                lambda s: s.shape, layout) if sharded else None)
            probe = _StepProbe(build_train_step(cfg, opt, sharded=sharded))
            metrics = []
            with activate_rules(rules if sharded else None):
                for b in batches:
                    params, state, m = probe(params, state, b)
                    metrics.append({k: v.detach().clone()
                                    for k, v in m.items()})
                final = (gather_params(params, layout, rules) if sharded
                         else params)
            runs[label] = dict(
                metrics=metrics, probe=probe,
                final=[t.detach() for t in adamw.tree_leaves(final)])
            del state, params
            gc.collect()
    finally:
        torch.use_deterministic_algorithms(False)
        undo()
        dist.destroy_process_group()
    rep, shd = runs["replicated"], runs["sharded"]
    same_metrics = all(a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) for k in a)
        for a, b in zip(rep["metrics"], shd["metrics"]))
    differing = [i for i, (a, b) in enumerate(zip(rep["final"], shd["final"]))
                 if not torch.equal(a, b)]
    rec = {"config": cfg.name, "layers": cfg.num_layers, "batch": batch,
           "seq": seq, "steps": SHARD_STEPS, "state_dtype": "int8",
           "mesh": [1, 1],
           "losses": {k: [m["total_loss"].item() for m in r["metrics"]]
                      for k, r in runs.items()},
           "grad_norm": {k: [m["grad_norm"].item() for m in r["metrics"]]
                         for k, r in runs.items()},
           "step_ms": {k: [s[0] * 1e3 for s in r["probe"].steps]
                       for k, r in runs.items()},
           "bitwise": {"metrics": same_metrics,
                       "params_differing": differing,
                       "leaves": len(rep["final"])},
           "launches_per_step": want,
           "launches": _run_launches(shd["probe"]),
           "plain_calls": dict(plain_calls)}
    log(f"[{tag}] ({part}) {cfg.name} {cfg.num_layers} layers, bf16 over "
        f"f32 masters, int8 moments, B {batch} x S {seq}, {SHARD_STEPS} steps "
        f"under deterministic algorithms, replicated vs sharded on a "
        f"one-process NCCL (1, 1) mesh: losses {rec['losses']}; metrics "
        f"equal {same_metrics}; final parameters differing {differing} of "
        f"{len(rep['final'])}; step ms {rec['step_ms']}; sharded launches "
        f"{rec['launches']} ({want} a step); on {smi}")
    _probe_launches(f"{tag} ({part})", shd["probe"], want, want_routes)
    if sum(plain_calls.values()):
        raise AssertionError(f"{tag} ({part}): a plain version ran on the "
                             f"card: {plain_calls}")
    if not same_metrics or differing:
        raise AssertionError(f"{tag} ({part}): the sharded step on one "
                             f"rank is not the replicated step bit for bit: "
                             f"{rec['bitwise']}")
    return rec


def _sharded_production(smi, arch="internlm2-1.8b",
                        local_flash=SHARD_LOCAL_FLASH,
                        local_rms=SHARD_LOCAL_RMS, tag="sharding",
                        launches=_transformer_step_launches,
                        attn=("layers", "attn"), local_ssd_heads=None):
    """(b) rank 0 of the single-pod (16, 16) ("data", "model") mesh over a
    fake process group of 256 ranks (``launch.dryrun.fake_mesh``, which
    registers the fake backend for CUDA too): internlm2-1.8b (or ``arch``)
    ``train_4k`` (B 256 x S 4096, rank 0's 16 rows), only rank 0's shards
    allocated (``init_params(..., rules=)``, the master weights in the
    config's ``param_dtype``, the cell's default AdamW: f32 moments, int8
    for bf16 masters), ``SHARD_PROD_STEPS`` sharded steps. The collectives move
    nothing, so the loss is not a result. Held: the measured peak device
    memory within ``LAUNCH_MEMORY_TOL`` of the dry-run's sharded
    ``per_device_total`` for the same cell, and every step's launches
    exactly the train phase's kinds at the local shapes (``local_flash``:
    B, S, query heads, KV heads, hd, of the attention leaves at the path
    ``attn``; ``local_rms``: rows, D; ``local_ssd_heads``: the Mamba2
    layers' local SSM heads), every bf16 one on sm90 (``launches(cfg)``:
    the step's launches and launches by route)."""
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.distributed import activate_rules
    from repro_torch.launch.dryrun import analyze_cell, cell_rules, fake_mesh
    from repro_torch.launch.input_specs import default_opt_cfg
    from repro_torch.models import get_family, init_params
    from repro_torch.models.params import tree_map_specs
    from repro_torch.train import adamw, build_train_step
    cfg = get_config(arch)
    shape = get_shape("train_4k")
    layout = get_family(cfg).layout(cfg)
    opt = default_opt_cfg(cfg)
    want, want_routes = launches(cfg)
    plain_calls, undo = _plain_call_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    try:
        with fake_mesh("single") as mesh:
            rules = cell_rules(cfg, shape, mesh)
            rows = shape.global_batch // rules.axis_sizes["data"]
            params = init_params(cfg, layout, seed=0, device="cuda",
                                 dtype=cfg.pdtype, rules=rules)
            for p in adamw.tree_leaves(params):
                p.requires_grad_(True)
            state = adamw.init(opt, params,
                               tree_map_specs(lambda s: s.shape, layout))
            batches = _shard_batches(cfg, SHARD_PROD_STEPS, rows,
                                     shape.seq_len, seed=3,
                                     dtype=torch.int32)
            leaves = params
            for key in attn:
                leaves = leaves[key]
            local = {k: tuple(v.shape) for k, v in leaves.items()}
            # the kernel phase held the kernels to their plain versions at
            # these local shapes (phase_backward_kernels, or phase 8e's own)
            fb, fs, fh, fkv, fhd, _ = local_flash
            # heads whole or KV heads split: the local KV heads; heads split
            # over whole KV heads: the one KV head the rank's heads use
            heads_whole = local["wq"][-2] == cfg.num_heads
            kv_split = local["wk"][-2] != cfg.num_kv_heads
            kv = local["wk"][-2] if heads_whole or kv_split else 1
            ssd_heads = (params["mamba"]["dt_bias"].shape[-1]
                         if local_ssd_heads else None)
            if ((rows, shape.seq_len, local["wq"][-2], kv, cfg.head_dim)
                    != (fb, fs, fh, fkv, fhd)
                    or (rows * shape.seq_len, cfg.d_model) != local_rms
                    or ssd_heads != local_ssd_heads):
                raise AssertionError(
                    f"{tag} (b): local shapes {rows} x {shape.seq_len}, "
                    f"attention {local}, SSM heads {ssd_heads}, not the "
                    f"kernel checks' {local_flash}, {local_rms} and "
                    f"{local_ssd_heads}")
            probe = _StepProbe(build_train_step(cfg, opt, sharded=True))
            device_ms = []
            with activate_rules(rules):
                for b in batches:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    params, state, _ = probe(params, state, b)
                    end.record()
                    torch.cuda.synchronize()
                    device_ms.append(start.elapsed_time(end))
            peak = torch.cuda.max_memory_allocated() - held
            del params, state, batches
    finally:
        undo()
    gc.collect()
    torch.cuda.empty_cache()
    dry = analyze_cell(cfg, shape, "single")
    predicted = dry["memory"]["per_device_total"]
    roof = dry["roofline"]
    rec = {"config": cfg.name, "shape": dataclasses.asdict(shape),
           "mesh": list(rules.axis_sizes.values()), "rank": 0, "rows": rows,
           "steps": SHARD_PROD_STEPS, "state_dtype": opt.state_dtype,
           "local_attention_shapes": local,
           "measured_peak_bytes": peak, "allocated_before_bytes": held,
           "predicted_per_device_bytes": predicted,
           "memory_rel_err": predicted / peak - 1.0,
           "dryrun_param_placement": dry["param_placement"],
           "dryrun_memory": dry["memory"],
           "step_device_ms": device_ms,
           "step_ms": [s[0] * 1e3 for s in probe.steps],
           "roofline_terms_s": {k: roof[k] for k in
                                ("compute_s", "memory_s", "collective_s")},
           "memory_fused_s": roof["memory_fused_s"],
           "collective_by_op": dry["hlo"]["collective_by_op"],
           "launches_per_step": want, "launches": _run_launches(probe),
           "plain_calls": dict(plain_calls), "card": smi}
    log(f"[{tag}] (b) {cfg.name} train_4k on rank 0 of the "
        f"{tuple(rules.axis_sizes.values())} mesh (a fake process group), "
        f"{rows} rows x {shape.seq_len}, "
        f"rank 0's shards only (attention leaves {local}), "
        f"{opt.state_dtype} moments, "
        f"{SHARD_PROD_STEPS} steps: peak device memory {peak / 2**30:.3f} "
        f"GiB vs the dry-run's sharded per_device_total "
        f"{predicted / 2**30:.3f} GiB ({rec['memory_rel_err'] * 100:+.2f}%);"
        f" step device ms {[round(x, 1) for x in device_ms]} beside the "
        f"dry-run's compute {roof['compute_s'] * 1e3:.1f} / memory "
        f"{roof['memory_s'] * 1e3:.1f} (fused "
        f"{roof['memory_fused_s'] * 1e3:.1f}) / collective "
        f"{roof['collective_s'] * 1e3:.1f} ms; launches {rec['launches']} "
        f"({want} a step); on {smi}")
    _probe_launches(f"{tag} (b)", probe, want, want_routes)
    if sum(plain_calls.values()):
        raise AssertionError(f"{tag} (b): a plain version ran on the "
                             f"card: {plain_calls}")
    if dry["param_placement"] != "sharded" or not dry["memory"]["fits_hbm"]:
        raise AssertionError(f"{tag} (b): the dry-run says "
                             f"{dry['param_placement']}, fits "
                             f"{dry['memory']['fits_hbm']}")
    if abs(rec["memory_rel_err"]) > LAUNCH_MEMORY_TOL:
        raise AssertionError(f"{tag} (b): predicted {predicted} bytes, "
                             f"measured {peak}: more than "
                             f"{LAUNCH_MEMORY_TOL:.0%} apart")
    return rec


def phase_sharding(smi: str):
    """(a) the sharded train step on a one-process (1, 1) mesh, bit for bit
    the replicated step (``_sharded_one_rank``); (b) rank 0 of the
    production mesh at internlm2-1.8b's ``train_4k`` cell against the
    dry-run's sharded prediction (``_sharded_production``)."""
    import torch
    t0 = time.perf_counter()
    rec = {"one_rank": _sharded_one_rank(smi)}
    gc.collect()
    torch.cuda.empty_cache()
    rec["production"] = _sharded_production(smi)
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# ---------------------------------------------------------------------------
# phase 8d: expert parallel -- the sharded MoE train step on a (1, 1) mesh
# and on rank 0 of the production mesh
# ---------------------------------------------------------------------------

#: (a): olmoe-1b-7b's depth on the one-process (1, 1) mesh.
EP_LAYERS = 4


def phase_expert_parallel(smi: str):
    """(a) olmoe-1b-7b at full width and depth ``EP_LAYERS`` (64 experts
    top 8, bf16 over f32 masters, int8 moments), B ``TB`` x S ``TS`` (16
    groups of 512), ``SHARD_STEPS`` steps under deterministic algorithms,
    the replicated step against the sharded one on a one-process NCCL
    (1, 1) mesh (``_sharded_one_rank``): losses, metrics and the gathered
    final parameters bit for bit, launches exactly the replicated step's,
    every bf16 one on sm90, no plain version called. (b) rank 0 of the
    single-pod (16, 16) mesh over a fake process group
    (``_sharded_production``): olmoe-1b-7b ``train_4k`` at full depth
    (f32 masters and moments), then arctic-480b ``train_4k`` (bf16
    masters, int8 moments, all 35 layers), only rank 0's shards
    allocated, ``SHARD_PROD_STEPS`` steps each: the measured peak device
    memory within 3% of the dry-run's sharded ``per_device_total``,
    launches exact at the local shapes (olmoe: ``SHARD_LOCAL_FLASH``,
    ``SHARD_LOCAL_RMS``; arctic: ``ARCTIC_LOCAL_FLASH``,
    ``ARCTIC_LOCAL_RMS``), all on sm90; each step's device ms beside the
    dry-run's compute and memory terms."""
    import torch
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    tag = "expert parallel"
    cfg = get_config("olmoe-1b-7b").replace(num_layers=EP_LAYERS)
    rec = {"one_rank": _sharded_one_rank(smi, cfg, tag=tag)}
    for arch, flash, rms in (
            ("olmoe-1b-7b", SHARD_LOCAL_FLASH, SHARD_LOCAL_RMS),
            ("arctic-480b", ARCTIC_LOCAL_FLASH, ARCTIC_LOCAL_RMS)):
        gc.collect()
        torch.cuda.empty_cache()
        rec[arch] = _sharded_production(smi, arch, flash, rms, tag=tag)
    rec["phase_s"] = time.perf_counter() - t0
    log(f"[{tag}] phase {rec['phase_s']:.1f} s on {smi}")
    return rec


# ---------------------------------------------------------------------------
# phase 8e: ssm sharding -- the sharded Zamba2 and xLSTM train steps on a
# (1, 1) mesh, and zamba2-1.2b on rank 0 of the production mesh
# ---------------------------------------------------------------------------

#: (a): zamba2-1.2b's depth on the one-process (1, 1) mesh: one group of 6
#: Mamba2 layers and one shared application.
SSM_ZAMBA_LAYERS = 6
#: (c): xlstm-350m's depth (one mLSTM/sLSTM pair), batch and sequence on
#: the (1, 1) mesh.
SSM_XLSTM_LAYERS, SSM_XB, SSM_XS = 2, 8, 256
# The kernels' local shapes in (b), zamba2-1.2b ``train_4k`` on rank 0 of
# the (16, 16) mesh: 16 rows of 4096; the SSD over 4 of the 64 heads (N =
# P = 64, chunk 128: B, S, heads, chunk); the shared block's flash over 2
# of the 32 heads, hd 64, causal; RMSNorm over 16 x 4096 rows of 2048 (the
# block norms) and of 4096 (the gated norm, on whole rows).
ZAMBA_LOCAL_SSD = (16, 4096, 4, Z_CHUNK)
ZAMBA_LOCAL_FLASH = (16, 4096, 2, 2, 64, True)
ZAMBA_LOCAL_RMS = ((16 * 4096, 2048), (16 * 4096, 4096))


def _zamba_local_kernels():
    """Every kernel of (b)'s step, bf16, at rank 0's local shapes against
    its plain version on the same inputs: the SSD scan (``ZAMBA_LOCAL_SSD``;
    one launch on sm90, y and the final state within TOL_BF16 of their max
    |plain|) and its backward (twice, bit for bit, on sm90; dx, dB and dC
    within TOL_BF16, ddt and da_log within TOL_F32); flash attention's
    backward and forward (``ZAMBA_LOCAL_FLASH``) and RMSNorm's at both
    widths (``ZAMBA_LOCAL_RMS``, f32 weights away from one) through
    ``_bwd_twice`` and ``_sharded_local_fwd``. -> {kernel: {shape: max
    error}}."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_path
    tag = "ssm sharding"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    bf = torch.bfloat16
    b, s, h, chunk = ZAMBA_LOCAL_SSD
    out = {}
    kern, plain = _ssd_case(gen, dev, bf, b, s, chunk, h=h)
    K.reset_launch_counts()
    got = kern()
    torch.cuda.synchronize()
    routes = K.launch_counts_by_route()["ssd_scan"]
    errs = [_rel_err(x, y) for x, y in zip(got, plain())]
    ok = (routes["sm90"] == 1 and sum(K.launch_counts().values()) == 1
          and all(math.isfinite(e) and e <= TOL_BF16 for e in errs))
    log(f"[{tag}] ssd_scan bf16 local {ZAMBA_LOCAL_SSD}: max|kernel-plain|"
        f"/max|plain| y, h_final {['%.2e' % e for e in errs]} (tol "
        f"{TOL_BF16}), routes {routes} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: ssd_scan at the local shape: {errs}, "
                             f"routes {routes}")
    out["ssd_scan"] = {str(ZAMBA_LOCAL_SSD): max(errs)}
    del got, kern, plain
    kern, plain, _ = _ssd_bwd_case(gen, dev, bf, b, s, chunk, h=h)
    K.reset_launch_counts()
    got, again = kern(), kern()
    torch.cuda.synchronize()
    routes = K.launch_counts_by_route()["ssd_scan_bwd"]
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    errs = [_rel_err(x, y) for x, y in zip(got, plain())]
    tols = [TOL_BF16 if x.dtype == bf else TOL_F32 for x in got]
    ok = (routes["sm90"] == 2 and sum(K.launch_counts().values()) == 2
          and same and all(math.isfinite(e) and e <= t
                           for e, t in zip(errs, tols)))
    log(f"[{tag}] ssd_scan_bwd bf16 local {ZAMBA_LOCAL_SSD}: "
        f"max|kernel-plain|/max|plain| dx, ddt, da_log, dB, dC "
        f"{['%.2e' % e for e in errs]} (tol {tols}), repeat bitwise {same}, "
        f"routes {routes} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: ssd_scan_bwd at the local shape: "
                             f"{errs}, repeat {same}, routes {routes}")
    out["ssd_scan_bwd"] = {str(ZAMBA_LOCAL_SSD): max(errs)}
    del got, again, kern, plain
    torch.cuda.empty_cache()
    kern, plain, inputs = _flash_bwd_case(gen, dev, bf, *ZAMBA_LOCAL_FLASH)
    out["flash_attention_bwd"] = {str(ZAMBA_LOCAL_FLASH): _bwd_twice(
        tag, "flash_attention_bwd", f"bf16 local {ZAMBA_LOCAL_FLASH}",
        "sm90", kern, plain)}
    out["flash_attention_fwd"] = {str(ZAMBA_LOCAL_FLASH): _sharded_local_fwd(
        "flash_attention_bwd", inputs, ZAMBA_LOCAL_FLASH)}
    del kern, plain, inputs
    torch.cuda.empty_cache()
    out["rmsnorm_bwd"], out["rmsnorm_fused"] = {}, {}
    for rows, d in ZAMBA_LOCAL_RMS:
        kern, plain, inputs = _rms_bwd_case(gen, dev, bf, rows, d,
                                            w_mean=0.25, w_std=0.05)
        out["rmsnorm_bwd"][f"{rows}x{d}"] = _bwd_twice(
            tag, "rmsnorm_bwd", f"bf16 local {rows}x{d}",
            rmsnorm_path(d, bf), kern, plain)
        out["rmsnorm_fused"][f"{rows}x{d}"] = _sharded_local_fwd(
            "rmsnorm_bwd", inputs, (rows, d))
        del kern, plain, inputs
    torch.cuda.empty_cache()
    return out


def phase_ssm_sharding(smi: str):
    """The sharded train step on the Zamba2 and xLSTM families. (a)
    zamba2-1.2b at full width and depth ``SSM_ZAMBA_LAYERS``, B ``TB`` x S
    ``TS``, and (c) xlstm-350m at depth ``SSM_XLSTM_LAYERS``, B ``SSM_XB``
    x S ``SSM_XS``, each ``SHARD_STEPS`` steps under deterministic
    algorithms, the replicated step against the sharded one on a
    one-process NCCL (1, 1) mesh (``_sharded_one_rank``): losses, metrics
    and the gathered final parameters bit for bit, launches exactly the
    replicated step's (every bf16 SSD scan, its backward and flash on
    sm90), no plain version called. (b) rank 0 of the single-pod (16, 16)
    mesh over a fake process group (``_sharded_production``):
    zamba2-1.2b ``train_4k``, all 38 layers, only rank 0's shards
    allocated, ``SHARD_PROD_STEPS`` steps: the measured peak device memory
    within 3% of the dry-run's sharded ``per_device_total``, launches
    exact at the local shapes, each step's device ms beside the dry-run's
    terms; every kernel of that step first held to its plain version at
    those shapes (``_zamba_local_kernels``). xlstm-350m's ``train_4k`` on
    rank 0 is not run: its plain sLSTM loop at S 4096 waits for a fused
    sLSTM kernel."""
    import torch
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    tag, seconds = "ssm sharding", {}
    cfg = get_config("zamba2-1.2b").replace(num_layers=SSM_ZAMBA_LAYERS)
    rec = {"zamba_one_rank": _sharded_one_rank(
        smi, cfg, tag=tag, launches=_zamba_bf16_step(cfg))}
    seconds["a"] = time.perf_counter() - t0
    t = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("xlstm-350m").replace(num_layers=SSM_XLSTM_LAYERS)
    rec["xlstm_one_rank"] = _sharded_one_rank(
        smi, cfg, tag=tag, launches=_xlstm_step_launches(cfg), batch=SSM_XB,
        seq=SSM_XS, part="c")
    seconds["c"] = time.perf_counter() - t
    t = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rec["local_kernels"] = _zamba_local_kernels()
    seconds["local kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rec["zamba_production"] = _sharded_production(
        smi, "zamba2-1.2b", ZAMBA_LOCAL_FLASH, ZAMBA_LOCAL_RMS[0], tag=tag,
        launches=_zamba_bf16_step, attn=("shared", "attn"),
        local_ssd_heads=ZAMBA_LOCAL_SSD[2])
    seconds["b"] = time.perf_counter() - t
    rec["seconds"] = seconds
    rec["phase_s"] = time.perf_counter() - t0
    log(f"[{tag}] phase {rec['phase_s']:.1f} s "
        f"({ {k: round(v, 1) for k, v in seconds.items()} }) on {smi}")
    return rec


# ---------------------------------------------------------------------------
# phase 8f: serve sharding -- the sharded prefill, encode and decode steps
# on a (1, 1) mesh, and mistral-nemo-12b's and olmoe-1b-7b's serve cells on
# rank 0 of the production mesh
# ---------------------------------------------------------------------------

#: (a): the depth, batch, prompt length and decode steps on the one-process
#: (1, 1) mesh.
SERVE_SHARD_LAYERS, SERVE_SHARD_B, SERVE_SHARD_S = 2, 8, 1024
SERVE_SHARD_STEPS = 8
#: (b): the cells on rank 0 of the (16, 16) mesh, the steps of each, and
#: how far the measured peak device memory may be from the dry-run's.
SERVE_PROD_CELLS = (("mistral-nemo-12b", "prefill_32k"),
                    ("mistral-nemo-12b", "decode_32k"),
                    ("olmoe-1b-7b", "decode_32k"))
SERVE_PROD_STEPS = 2
SERVE_MEMORY_TOL = 0.01
# The kernels' local shapes in (b): mistral-nemo-12b ``prefill_32k`` on rank
# 0 is 2 rows of 32768; its flash over 2 of the 32 query heads and the one
# KV head they use, hd 128, causal (B, S, heads, KV heads, hd, causal);
# RMSNorm over 65536 rows of 5120, and at ``decode_32k`` over 8 rows of
# 5120 (mistral-nemo-12b) and of 2048 (olmoe-1b-7b). The plain flash takes
# the first and the last SERVE_FLASH_ROWS query rows: its whole S^2 scores
# would not fit.
SERVE_LOCAL_FLASH = (2, 32768, 2, 1, 128, True)
SERVE_LOCAL_RMS = ((2 * 32768, 5120), (8, 5120), (8, 2048))
SERVE_FLASH_ROWS = 1024


def _attention_rows_plain(q, k, v, start: int):
    """The plain causal attention of the query rows ``q`` (B,R,H,hd) at
    positions ``start .. start + R - 1`` over every key of k/v (B,S,KV,hd):
    ``attention_reference``'s arithmetic with the rows' causal mask."""
    import torch
    b, r, h, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, r, nkv, h // nkv, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    rows = start + torch.arange(r, device=q.device)
    s = torch.where(rows[:, None] >= torch.arange(k.shape[1],
                                                  device=q.device)[None],
                    s, -1e30)
    out = torch.einsum("bkgqs,bskh->bqkgh", torch.softmax(s, dim=-1),
                       v.float())
    return out.reshape(q.shape).to(q.dtype)


def _serve_local_kernels():
    """The two kernels of (b)'s steps at rank 0's local shapes in bf16,
    once each, against their plain versions on the same inputs: flash
    (``SERVE_LOCAL_FLASH``; its first and last ``SERVE_FLASH_ROWS`` rows)
    and RMSNorm (``SERVE_LOCAL_RMS``, f32 weights away from one), each
    within TOL_BF16 of its max |plain|, one launch, flash on sm90. ->
    {kernel: {shape: max error}}."""
    import torch
    from repro_torch import kernels as K
    tag = "serve sharding"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    bf = torch.bfloat16
    b, s, h, kv, hd, causal = SERVE_LOCAL_FLASH
    q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=dev, dtype=bf)
               for n in (h, kv, kv))
    K.reset_launch_counts()
    out = K.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    routes = K.launch_counts_by_route()["flash_attention_fwd"]
    launches = sum(K.launch_counts().values())
    r = SERVE_FLASH_ROWS
    errs = [_rel_err(out[:, :r], K.attention_reference(
                q[:, :r], k[:, :r], v[:, :r], causal=causal)),
            _rel_err(out[:, -r:], _attention_rows_plain(q[:, -r:], k, v,
                                                        s - r))]
    ok = (routes["sm90"] == 1 and launches == 1
          and all(math.isfinite(e) and e <= TOL_BF16 for e in errs))
    log(f"[{tag}] flash_attention_fwd bf16 local {SERVE_LOCAL_FLASH}: "
        f"max|kernel-plain|/max|plain| first and last {r} rows "
        f"{['%.2e' % e for e in errs]} (tol {TOL_BF16}), {launches} launch, "
        f"routes {routes} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: flash at the local shape: {errs}, "
                             f"{launches} launches, routes {routes}")
    res = {"flash_attention_fwd": {str(SERVE_LOCAL_FLASH): max(errs)},
           "rmsnorm_fused": {}}
    del q, k, v, out
    for rows, d in SERVE_LOCAL_RMS:
        x = torch.randn(rows, d, generator=gen, device=dev, dtype=bf)
        w = 0.25 + 0.05 * torch.randn(d, generator=gen, device=dev)
        K.reset_launch_counts()
        out = K.rmsnorm_fused(x, w)
        torch.cuda.synchronize()
        launches = sum(K.launch_counts().values())
        err = _rel_err(out, K.rmsnorm_reference(x, w))
        ok = launches == 1 and math.isfinite(err) and err <= TOL_BF16
        log(f"[{tag}] rmsnorm_fused bf16 local {rows}x{d}: "
            f"max|kernel-plain|/max|plain| {err:.2e} (tol {TOL_BF16}), "
            f"{launches} launch {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: rmsnorm at {rows}x{d}: {err}, "
                                 f"{launches} launches")
        res["rmsnorm_fused"][f"{rows}x{d}"] = err
        del x, w, out
    torch.cuda.empty_cache()
    return res


def _serve_want(cfg, kind) -> tuple[dict, dict]:
    """(launches, flash launches by route) of one serve step of ``cfg``:
    flash once a layer in a prefill or encode (on sm90 in bf16, cuda_core
    in f32), none at decode; RMSNorm twice a layer and once at the end."""
    import torch
    layers = cfg.num_layers
    want = {"rmsnorm_fused": 2 * layers + 1}
    flash = {"sm90": 0, "cuda_core": 0}
    if kind != "decode":
        want["flash_attention_fwd"] = layers
        flash["sm90" if cfg.cdtype == torch.bfloat16 else "cuda_core"] = \
            layers
    return want, flash


def _serve_one_rank(smi):
    """(a) on a one-process NCCL (1, 1) ("data", "model") mesh, every
    collective issued over its one rank, at full width and depth
    ``SERVE_SHARD_LAYERS``, random weights from seed 0: the sharded serve
    steps against the replicated ones on the same weights and inputs.
    internlm2-1.8b's prefill, B ``SERVE_SHARD_B`` x S ``SERVE_SHARD_S``,
    bf16: logits and cache bit for bit; in bf16 and in f32 its prefill
    (replicated) then ``SERVE_SHARD_STEPS`` decode steps over the cache
    split by sequence over the one-rank "model" (its partial softmax and
    combine run): logits within 1e-5 relative (bf16 bit for bit, f32's
    bitwise reported), tokens and the cache after the last step equal;
    the same in f32 for olmoe-1b-7b (64 experts
    top 8, its group the whole batch); hubert-xlarge's encode of B x S
    frames, bf16: logits bit for bit. Every step's launches exact, no
    plain version called."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.distributed import ShardingRules, activate_rules
    from repro_torch.distributed.sharding import shard_params, shard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_family, init_params
    from repro_torch.train.train_step import (build_decode_step,
                                              build_encode_step,
                                              build_prefill_step,
                                              local_serve_batch)
    tag = "serve sharding"
    b, s, steps = SERVE_SHARD_B, SERVE_SHARD_S, SERVE_SHARD_STEPS
    smax = s + steps
    gen = torch.Generator(device="cuda")
    gen.manual_seed(43)
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    plain_calls, undo = _plain_call_counter()
    rec = {}
    try:
        rules = ShardingRules(mesh)
        drules = ShardingRules(mesh, {"cache_seq": "model"})
        for arch, dtype, kind in (("internlm2-1.8b", None, "prefill"),
                                  ("internlm2-1.8b", None, "decode"),
                                  ("internlm2-1.8b", "float32", "decode"),
                                  ("olmoe-1b-7b", "float32", "decode"),
                                  ("hubert-xlarge", None, "encode")):
            cfg = get_config(arch).replace(num_layers=SERVE_SHARD_LAYERS)
            cfg = cfg.replace(dtype=dtype) if dtype else cfg
            label = f"{arch} {kind} {cfg.dtype}"
            fam = get_family(cfg)
            layout = fam.layout(cfg)
            params = init_params(cfg, layout, seed=0, device="cuda")
            with activate_rules(rules):
                shards = shard_params(params, layout, rules)
            if cfg.frontend == "frame":
                batch = {"frames": torch.randn(
                    b, s, cfg.frontend_dim, generator=gen, device="cuda")}
            else:
                batch = {"tokens": torch.randint(
                    0, cfg.vocab_size, (b, s), generator=gen, device="cuda")}
            want = _serve_want(cfg, "prefill")
            K.reset_launch_counts()
            ref = (build_encode_step(cfg) if kind == "encode"
                   else build_prefill_step(cfg))(params, batch)
            torch.cuda.synchronize()
            _exact_launches(f"{tag} (a) {label} replicated", *want)
            if kind != "decode":
                K.reset_launch_counts()
                with activate_rules(rules):
                    got = (build_encode_step if kind == "encode"
                           else build_prefill_step)(
                        cfg, sharded=True, global_batch=b)(
                        shards, local_serve_batch(batch))
                torch.cuda.synchronize()
                launches = _exact_launches(f"{tag} (a) {label}", *want)
                pairs = ([(ref, got)] if kind == "encode" else
                         [(ref[0], got[0])] + [(ref[1][n], got[1][n])
                                               for n in ("k", "v")])
                same = all(torch.equal(x, y) for x, y in pairs)
                rec[label] = {"bitwise": same, "launches": launches}
                log(f"[{tag}] (a) {label}, {cfg.num_layers} layers, B {b} x "
                    f"S {s}: sharded vs replicated bit for bit {same}; "
                    f"launches {launches}")
                if not same:
                    raise AssertionError(f"{tag} (a): {label} is not the "
                                         f"replicated step bit for bit")
                del ref, got
            else:
                cache = {n: torch.nn.functional.pad(
                    t, (0, 0, 0, 0, 0, smax - s)) for n, t in ref[1].items()}
                del ref
                with activate_rules(drules):
                    scache = shard_tree({n: t.clone()
                                         for n, t in cache.items()},
                                        fam.cache_axes(cfg), drules)
                step = build_decode_step(cfg)
                sstep = build_decode_step(cfg, sharded=True, global_batch=b,
                                          cache_len=smax)
                want = _serve_want(cfg, "decode")
                errs, bitwise, tokens_equal, launches = [], True, True, {}
                for i in range(steps):
                    one = {"tokens": torch.randint(
                        0, cfg.vocab_size, (b, 1), generator=gen,
                        device="cuda"),
                        "pos": torch.full((b,), s + i, device="cuda",
                                          dtype=torch.int32)}
                    t0, l0, cache = step(params, one, cache)
                    K.reset_launch_counts()
                    with activate_rules(drules):
                        t1, l1, scache = sstep(shards, local_serve_batch(one),
                                               scache)
                    torch.cuda.synchronize()
                    for n, c in _exact_launches(f"{tag} (a) {label} step "
                                                f"{i + 1}", *want).items():
                        launches[n] = launches.get(n, 0) + c
                    errs.append(_rel_err(l1, l0))
                    bitwise = bitwise and torch.equal(l0, l1)
                    tokens_equal = tokens_equal and torch.equal(t0, t1)
                caches_equal = all(torch.equal(cache[n], scache[n])
                                   for n in ("k", "v"))
                rec[label] = {"logits_max_rel_err": max(errs),
                              "logits_bitwise": bitwise,
                              "tokens_equal": tokens_equal,
                              "caches_equal": caches_equal,
                              "launches": launches}
                log(f"[{tag}] (a) {label}, {cfg.num_layers} layers, B {b}, "
                    f"{steps} decode steps from position {s} over a "
                    f"{smax}-position cache split by sequence over the "
                    f"one-rank \"model\": logits max rel err {max(errs):.2e}"
                    f" (tol 1e-5), bit for bit {bitwise}; tokens equal "
                    f"{tokens_equal}; caches equal {caches_equal}; launches "
                    f"{launches}")
                # bf16 is held bit for bit: over one rank the combine's
                # weight is l / l = 1
                exact = bitwise or cfg.cdtype != torch.bfloat16
                if not (max(errs) <= 1e-5 and tokens_equal and caches_equal
                        and exact):
                    raise AssertionError(f"{tag} (a): {label}: {rec[label]}")
                del cache, scache
            del params, shards, batch
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        undo()
        dist.destroy_process_group()
    if sum(plain_calls.values()):
        raise AssertionError(f"{tag} (a): a plain version ran on the card: "
                             f"{plain_calls}")
    rec["card"] = smi
    return rec


def _serve_production(smi, arch, shape_name):
    """(b) rank 0 of the single-pod (16, 16) ("data", "model") mesh over a
    fake process group of 256 ranks (``launch.dryrun.fake_mesh``): ``arch``
    at the cell ``shape_name``, all its layers, only rank 0's parameter
    shards allocated (``init_params(..., rules=)``, ``cfg.dtype``), its
    rows of the batch and, at decode, its block of the cache (random,
    split by batch over "data" and by sequence over "model"; positions in
    rank 0's block, so it writes every new row); ``SERVE_PROD_STEPS``
    sharded steps. The collectives move nothing, so the logits are not a
    result. Held: the peak device memory of the steps (above what was
    allocated before the arguments) within ``SERVE_MEMORY_TOL`` of the
    dry-run's sharded ``per_device_total`` for the cell, every step's
    launches exact, flash on sm90; each step's device ms (between two
    events around it) and the host's time to enqueue it beside the
    dry-run's terms."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config, get_shape
    from repro_torch.distributed import activate_rules
    from repro_torch.distributed.sharding import local_shape
    from repro_torch.launch.dryrun import analyze_cell, cell_rules, fake_mesh
    from repro_torch.models import get_family, init_params
    from repro_torch.train.train_step import (build_decode_step,
                                              build_prefill_step)
    tag = "serve sharding"
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    fam = get_family(cfg)
    layout = fam.layout(cfg)
    decode = shape.kind == "decode"
    want = _serve_want(cfg, shape.kind)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(47)
    plain_calls, undo = _plain_call_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    device_ms, host_ms, launches = [], [], {}
    try:
        with fake_mesh("single") as mesh:
            rules = cell_rules(cfg, shape, mesh)
            rows = shape.global_batch // rules.axis_sizes["data"]
            params = init_params(cfg, layout, seed=0, device="cuda",
                                 rules=rules)
            cache = None
            if decode:
                whole = fam.cache_layout(cfg, shape.global_batch,
                                         shape.seq_len)
                axes = fam.cache_axes(cfg)
                cache = {n: torch.empty(local_shape(rules, whole[n][0],
                                                    axes[n]),
                                        dtype=whole[n][1],
                                        device="cuda").normal_(generator=gen)
                         for n in whole}
                step = build_decode_step(cfg, sharded=True,
                                         global_batch=shape.global_batch,
                                         cache_len=shape.seq_len)
                block = cache["k"].shape[2]
                batch = {"tokens": torch.randint(
                    0, cfg.vocab_size, (rows, 1), generator=gen,
                    device="cuda", dtype=torch.int32),
                    "pos": block // 2 + torch.arange(
                        rows, device="cuda", dtype=torch.int32)}
            else:
                step = build_prefill_step(cfg, sharded=True,
                                          global_batch=shape.global_batch)
                batch = {"tokens": torch.randint(
                    0, cfg.vocab_size, (rows, shape.seq_len), generator=gen,
                    device="cuda", dtype=torch.int32)}
            local = {"params_bytes": sum(
                p.numel() * p.element_size() for p in _leaves(params)),
                "cache_block": (list(cache["k"].shape) if decode else None)}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with activate_rules(rules):
                for i in range(SERVE_PROD_STEPS):
                    K.reset_launch_counts()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    t0 = time.perf_counter()
                    start.record()
                    out = (step(params, batch, cache) if decode
                           else step(params, batch))
                    end.record()
                    host_ms.append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.synchronize()
                    device_ms.append(start.elapsed_time(end))
                    for n, c in _exact_launches(
                            f"{tag} (b) {arch} {shape_name} step {i + 1}",
                            *want).items():
                        launches[n] = launches.get(n, 0) + c
                    if decode:
                        cache = out[2]
                        batch["pos"] = batch["pos"] + 1
                    del out
            peak = torch.cuda.max_memory_allocated() - held
            del params, cache, batch
    finally:
        undo()
    gc.collect()
    torch.cuda.empty_cache()
    dry = analyze_cell(cfg, shape, "single")
    predicted = dry["memory"]["per_device_total"]
    roof = dry["roofline"]
    rec = {"config": cfg.name, "shape": dataclasses.asdict(shape),
           "mesh": list(rules.axis_sizes.values()), "rank": 0, "rows": rows,
           "steps": SERVE_PROD_STEPS, **local,
           "measured_peak_bytes": peak, "allocated_before_bytes": held,
           "predicted_per_device_bytes": predicted,
           "memory_rel_err": predicted / peak - 1.0,
           "dryrun_param_placement": dry["param_placement"],
           "dryrun_memory": dry["memory"], "dryrun_trace_s": dry["trace_s"],
           "step_device_ms": device_ms, "step_enqueue_ms": host_ms,
           "roofline_terms_s": {k: roof[k] for k in
                                ("compute_s", "memory_s", "collective_s")},
           "memory_fused_s": roof["memory_fused_s"],
           "collective_by_op": dry["hlo"]["collective_by_op"],
           "launches_per_step": want[0], "launches": launches,
           "plain_calls": dict(plain_calls), "card": smi}
    log(f"[{tag}] (b) {cfg.name} {shape_name} on rank 0 of the "
        f"{tuple(rules.axis_sizes.values())} mesh (a fake process group), "
        f"{rows} rows, rank 0's shards only ({local}), {SERVE_PROD_STEPS} "
        f"steps: peak device memory {peak / 2**30:.3f} GiB vs the dry-run's "
        f"sharded per_device_total {predicted / 2**30:.3f} GiB "
        f"({rec['memory_rel_err'] * 100:+.2f}%); step device ms "
        f"{[round(x, 2) for x in device_ms]} (the host's enqueue of the "
        f"step {[round(x, 2) for x in host_ms]} ms) beside the dry-run's "
        f"compute "
        f"{roof['compute_s'] * 1e3:.2f} / memory {roof['memory_s'] * 1e3:.2f}"
        f" (fused {roof['memory_fused_s'] * 1e3:.2f}) / collective "
        f"{roof['collective_s'] * 1e3:.2f} ms; launches {launches} "
        f"({want[0]} a step); on {smi}")
    if sum(plain_calls.values()):
        raise AssertionError(f"{tag} (b): a plain version ran on the card: "
                             f"{plain_calls}")
    if dry["param_placement"] != "sharded" or not dry["memory"]["fits_hbm"]:
        raise AssertionError(f"{tag} (b): the dry-run says "
                             f"{dry['param_placement']}, fits "
                             f"{dry['memory']['fits_hbm']}")
    if abs(rec["memory_rel_err"]) > SERVE_MEMORY_TOL:
        raise AssertionError(f"{tag} (b): {cfg.name} {shape_name}: "
                             f"predicted {predicted} bytes, measured {peak}:"
                             f" more than {SERVE_MEMORY_TOL:.0%} apart")
    return rec


def phase_serve_sharding(smi: str):
    """The sharded serve steps of the transformer: (a) on a one-process
    (1, 1) mesh against the replicated steps (``_serve_one_rank``); the
    kernels of (b)'s steps at rank 0's local shapes against their plain
    versions (``_serve_local_kernels``); (b) rank 0 of the production mesh
    at mistral-nemo-12b's ``prefill_32k`` and ``decode_32k`` and
    olmoe-1b-7b's ``decode_32k`` against the dry-run
    (``_serve_production``)."""
    import torch
    t0 = time.perf_counter()
    tag, seconds = "serve sharding", {}
    rec = {"one_rank": _serve_one_rank(smi)}
    seconds["a"] = time.perf_counter() - t0
    t = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rec["local_kernels"] = _serve_local_kernels()
    seconds["local kernels"] = time.perf_counter() - t
    for arch, shape in SERVE_PROD_CELLS:
        t = time.perf_counter()
        rec[f"{arch} {shape}"] = _serve_production(smi, arch, shape)
        seconds[f"b {arch} {shape}"] = time.perf_counter() - t
    rec["seconds"] = seconds
    rec["phase_s"] = time.perf_counter() - t0
    log(f"[{tag}] phase {rec['phase_s']:.1f} s "
        f"({ {k: round(v, 1) for k, v in seconds.items()} }) on {smi}")
    return rec


def _serve_sharding_launches(ssv, name) -> dict:
    """A kernel's launches in phase 8f's runs, by run."""
    out = {label: r["launches"].get(name, 0)
           for label, r in ssv["one_rank"].items() if label != "card"}
    out.update({cell: ssv[cell]["launches"].get(name, 0)
                for cell in (f"{a} {s}" for a, s in SERVE_PROD_CELLS)})
    return out


# ---------------------------------------------------------------------------
# phase 9: the Kotta batch runtime -- a revoked full-width training job
# ---------------------------------------------------------------------------

def _job_service(watcher_kwargs, vocab_size: int):
    """A ``KottaService`` with the standard roles; the train phase's corpus
    under dataset/<TRAIN_CORPUS>/; a ``researcher`` role over it, results/*
    and queue/* that ``task-executor`` may assume, bound to alice; an
    ``outsider`` role over queue/* alone, bound to mallory."""
    from repro_torch.core import (ExecutableRegistry, KottaService,
                                  ObjectStore, PolicyEngine, Principal, Role,
                                  allow, install_standard_roles)
    from repro_torch.data import SyntheticCorpus
    engine = PolicyEngine()
    install_standard_roles(engine)
    store = ObjectStore(clock=engine.clock)
    svc = KottaService(engine, store, ExecutableRegistry(),
                       watcher_kwargs=watcher_kwargs)
    shards = tuple(SyntheticCorpus.build(store, TRAIN_CORPUS, **TRAIN_SHARDS,
                                         vocab_size=vocab_size))
    engine.register_role(Role("researcher", policies=[
        allow(["data:Get", "data:List"], [f"dataset/{TRAIN_CORPUS}/*"]),
        allow(["data:*"], ["results/*"]),
        allow(["jobs:*"], ["queue/*"])], trusted_assumers={"task-executor"}))
    engine.register_role(Role("outsider", policies=[
        allow(["jobs:*"], ["queue/*"])]))
    for uid, role in (("alice", "researcher"), ("mallory", "outsider")):
        engine.authenticator.register_identity(Principal(uid), "pw")
        engine.bind(Principal(uid), role)
    return svc, shards


def _train_lm(svc, cfg, opt):
    """The ``train_lm`` executable: ``ElasticTrainer`` on the card over the
    staged shards (the train phase's batch, seed, config and optimizer),
    checkpointing into the service's store under job-<id>, reporting a
    heartbeat after every step. Its ``revoke_at`` hook is a cancellation
    point; on the first attempt, at TRAIN_REVOKE, it first revokes the
    worker running it (a spot reclaim) and adds a replacement prod worker,
    so the JobCancelled that follows leaves the trainer mid-run. Stages out
    the losses and the final state's SHA-256. Returns the executable and a
    list of its attempts' records (worker, device memory at the start,
    times, step probe, checkpoint events, heartbeat times)."""
    import threading
    import numpy as np
    import torch
    from repro_torch.data import TokenLoader
    from repro_torch.train import ElasticTrainer
    attempts = []

    def train_lm(ctx):
        worker = threading.current_thread()
        torch.cuda.synchronize()
        att = {"worker": worker, "allocated_at_start":
               torch.cuda.memory_allocated(), "t_start": time.perf_counter()}
        attempts.append(att)
        loader = TokenLoader(lambda k: ctx.staged_inputs[k],
                             sorted(ctx.staged_inputs), batch_size=TB,
                             seq_len=TS, seed=0)
        ck = _timed_checkpointer(svc.store, f"job-{ctx.job_id}")
        trainer = ElasticTrainer(cfg, opt, ck, seed=0, device="cuda")
        probe, at = _StepProbe(trainer._step_fn), [0]
        att.update(probe=probe, events=ck.events, beats=[att["t_start"]])

        def step(params, opt_state, batch):
            att.setdefault("t_first_step", time.perf_counter())
            out = probe(params, opt_state, batch)
            ctx.report(step=at[0] + 1, loss=float(out[2]["total_loss"]))
            att["beats"].append(time.perf_counter())
            return out

        def revoke_at(step):
            at[0] = step
            if step == TRAIN_REVOKE and len(attempts) == 1:
                att["t_revoke"] = time.perf_counter()
                worker.revoke()
                att["replacement"] = svc.add_worker("prod")
            ctx.checkpoint()
            return False

        trainer._step_fn = step
        rep = trainer.train(loader, TRAIN_STEPS, checkpoint_every=TRAIN_EVERY,
                            revoke_at=revoke_at)
        digest = _state_digest(trainer.final_state)
        att["beats"].append(time.perf_counter())
        ctx.outputs[f"results/{ctx.job_id}/losses.npy"] = np.asarray(
            [rep.losses[k] for k in sorted(rep.losses)]).tobytes()
        ctx.outputs[f"results/{ctx.job_id}/state.sha256"] = digest.encode()
        return {"first_step": min(rep.losses), "steps_run": rep.steps_run}

    return train_lm, attempts


def phase_job(smi: str, train: dict):
    """The Kotta batch runtime on the card: the train phase's full-width
    internlm2-1.8b run as a ``KottaService`` job. mallory's submit is
    refused and audited; alice's job, on a preemptible prod worker, is
    revoked through ``Worker.revoke()`` at step TRAIN_REVOKE and resumed
    by a replacement worker from the step-TRAIN_EVERY checkpoint, under
    ``torch.use_deterministic_algorithms``. Held to: COMPLETED with the
    revocation's note, finished by the replacement, no watcher
    resubmission or speculation (the heartbeat timeout is twice the train
    phase's whole uninterrupted run and digest, and the longest measured
    stretch without a heartbeat must stay under it), the executor's
    assume-role and the staging reads in the audit log, the outputs
    alice's, the final state's SHA-256 equal to the train phase's
    uninterrupted run's, every step's launches exactly the train phase's,
    the job's launches counted from 0 exactly 7 steps' worth, no plain
    version called, the first attempt's tensors gone when the second
    starts, and every thread joined at shutdown. Then the port's
    simulator's Table VII-C rows (2016 EC2 prices; a simulation)."""
    import statistics as st
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import (AuthorizationError, JobSpec, JobStatus,
                                  run_table7c)
    from repro_torch.train import AdamWConfig
    cfg = get_config("internlm2-1.8b")
    opt = AdamWConfig(learning_rate=TRAIN_LR, warmup_steps=2,
                      decay_steps=100, state_dtype="int8")
    want = train["launches_per_step"]
    want_routes = train["launches_by_route_per_step"]
    timeout_s = 2.0 * (train["uninterrupted_run_s"] + train["digest_s"])
    svc, shards = _job_service({"heartbeat_timeout_s": timeout_s,
                                "interval_s": 0.05, "speculation": False},
                               cfg.vocab_size)
    train_lm, attempts = _train_lm(svc, cfg, opt)
    svc.registry.register("train_lm", train_lm)
    engine = svc.engine
    plain_calls, undo = _plain_call_counter()
    torch.use_deterministic_algorithms(True)
    try:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        svc.start(dev_workers=1, prod_workers=1)
        spot = svc.workers("prod")[0]
        try:
            svc.submit(engine.login("mallory", "pw"),
                       JobSpec("train_lm", inputs=shards, queue="prod"))
        except AuthorizationError as e:
            refused = str(e)
        else:
            raise AssertionError("job: mallory's submit was accepted")
        with _GpuSampler() as gpu:
            K.reset_launch_counts()
            t0 = time.perf_counter()
            job = svc.submit(engine.login("alice", "pw"),
                             JobSpec("train_lm", inputs=shards, queue="prod"))
            rec = svc.wait(job, timeout_s=300, poll_s=0.05)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = K.launch_counts()
            peak = torch.cuda.max_memory_allocated()
    finally:
        svc.shutdown()
        torch.use_deterministic_algorithms(False)
        undo()
    alive = [t.name for t in svc._threads if t.is_alive()]
    first, second = attempts if len(attempts) == 2 else (None, None)
    if rec["status"] != JobStatus.COMPLETED or first is None:
        raise AssertionError(f"job: {rec} after {len(attempts)} attempts")
    steps = first["probe"].steps + second["probe"].steps
    step_s = [dt for dt, _, _ in steps]
    steady = st.median([dt for dt, _, _ in first["probe"].steps[1:]
                        + second["probe"].steps[1:]])
    clocks = {f"attempt {i + 1}": gpu.during(a["probe"].windows)
              for i, a in enumerate(attempts)}
    saves = [e for a in attempts for e in a["events"] if e[0] == "save"]
    restores = [e for a in attempts for e in a["events"]
                if e[0] == "restore"]
    gaps = [b - a for att in attempts
            for a, b in zip(att["beats"], att["beats"][1:])]
    audit = engine.audit.records()
    mallory = [r for r in audit if r.principal_id == "mallory"]
    assumes = [(r.decision, r.principal_id, r.role_name, r.resource)
               for r in audit if r.action == "sts:AssumeRole"]
    reads = {k: [(r.principal_id, r.role_name) for r in audit
                 if r.action == "data:Get" and r.resource == k
                 and r.decision == "allow"] for k in shards}
    outputs = {k: svc.store.head(k).owner
               for k in svc.store.keys(f"results/{job}/")}
    digest = bytes(svc.store.get(f"results/{job}/state.sha256")).decode()
    losses = np.frombuffer(bytes(svc.store.get(f"results/{job}/losses.npy")))
    total = {k: v for k, v in counts.items() if v}
    job_steps = TRAIN_REVOKE + TRAIN_STEPS - TRAIN_EVERY      # 4 + 3
    rows = run_table7c()
    res = {
        "config": "internlm2-1.8b", "layers": cfg.num_layers, "batch": TB,
        "seq": TS, "steps": TRAIN_STEPS, "revoked_at": TRAIN_REVOKE,
        "resumed_from": TRAIN_EVERY, "job_wall_s": wall,
        "step_ms": [x * 1e3 for x in step_s],
        "step_ms_median_after_first": steady * 1e3,
        "gpu_during_steps": clocks,
        "save_s": [e[2] for e in saves], "restore_s": [e[2] for e in restores],
        "revocation_to_second_start_s": second["t_start"] - first["t_revoke"],
        "revocation_to_second_first_step_s":
            second["t_first_step"] - first["t_revoke"],
        "max_memory_allocated_bytes": peak, "allocated_before_bytes": held,
        "allocated_at_attempt_start_bytes": [a["allocated_at_start"]
                                             for a in attempts],
        "heartbeat_timeout_s": timeout_s, "longest_heartbeat_gap_s": max(gaps),
        "workers": [first["worker"].name, second["worker"].name],
        "finished_by": rec["worker"], "note": rec.get("note"),
        "resubmissions": svc.watcher.resubmissions,
        "speculations": svc.watcher.speculations,
        "state_sha256": digest, "launches": total,
        "threads_alive_after_shutdown": alive,
        "table7c_simulation_2016_prices": [
            {"policy": r.policy, "max_nodes": r.max_nodes,
             "makespan_h": r.makespan_s / 3600, "on_demand_usd":
             r.on_demand_cost, "spot_usd": r.spot_cost,
             "max_wait_h": r.max_wait_s / 3600, "revocations": r.revocations}
            for r in rows]}
    mib = 2 ** 20
    log(f"[job] internlm2-1.8b {cfg.num_layers} layers, B {TB} x S {TS} as "
        f"a KottaService job: mallory refused ({refused}); alice's job on "
        f"{first['worker'].name} revoked at step {TRAIN_REVOKE}, resumed by "
        f"{second['worker'].name} from step {TRAIN_EVERY}, finished by "
        f"{rec['worker']} ({rec.get('note')}); job wall {wall:.1f} s; step "
        f"ms {[round(x * 1e3, 1) for x in step_s]} (median after each "
        f"attempt's first {steady * 1e3:.1f}); saves "
        f"{[round(e[2], 2) for e in saves]} s, restore "
        f"{[round(e[2], 2) for e in restores]} s; revocation -> second "
        f"attempt's start {res['revocation_to_second_start_s']:.2f} s, -> its"
        f" first step {res['revocation_to_second_first_step_s']:.2f} s; "
        f"device memory allocated at each attempt's start "
        f"{[round(a['allocated_at_start'] / mib, 1) for a in attempts]} MiB "
        f"({held / mib:.1f} MiB before the job), peak {peak / 2**30:.2f} "
        f"GiB; longest stretch without a heartbeat {max(gaps):.2f} s "
        f"(timeout {timeout_s:.1f} s); resubmissions "
        f"{svc.watcher.resubmissions}, speculations "
        f"{svc.watcher.speculations}; state SHA-256 {digest[:16]}... equal "
        f"to the train phase's: {digest == train['state_sha256']}; launches "
        f"{total}; {_clock_text(clocks)}; on {smi}")
    log("[job] Table VII-C from the port's simulator (a simulation at the "
        "paper's 2016 EC2 prices, not a card number): " + "; ".join(
            f"{r.policy} {r.max_nodes}: makespan {r.makespan_s / 3600:.2f} h"
            f", on-demand ${r.on_demand_cost:.2f}, spot ${r.spot_cost:.2f}"
            for r in rows) + f"; static-40 on-demand over unlimited spot "
        f"{rows[0].on_demand_cost / rows[2].spot_cost:.1f}x")
    problems = []
    if not (mallory and mallory[-1].decision == "deny"):
        problems.append(f"mallory's refusal not audited: {mallory}")
    if rec.get("note") != "revoked mid-run":
        problems.append(f"note {rec.get('note')!r}")
    if not (first["worker"] is spot and first["worker"]._revoked.is_set()
            and second["worker"] is first.get("replacement")
            and rec["worker"] == second["worker"].name != spot.name):
        problems.append(f"workers {res['workers']}, finished by "
                        f"{rec['worker']}")
    if svc.watcher.resubmissions or svc.watcher.speculations:
        problems.append("the watcher re-ran the job")
    if max(gaps) >= timeout_s:
        problems.append(f"a heartbeat gap of {max(gaps):.1f} s")
    if assumes != [("allow", "service:task-executor", "task-executor",
                    "role/researcher")] * 2:
        problems.append(f"assume-role audit {assumes}")
    for k, got in reads.items():
        if got != [("alice", "researcher")] + [
                ("service:task-executor", "researcher")] * 2:
            problems.append(f"reads of {k}: {got}")
    if set(outputs) != {f"results/{job}/losses.npy",
                        f"results/{job}/state.sha256"} \
            or set(outputs.values()) != {"alice"}:
        problems.append(f"outputs {outputs}")
    if digest != train["state_sha256"]:
        problems.append("the final state differs from the train phase's")
    if losses.tolist() != [train["losses"][str(k)] for k in
                           range(TRAIN_EVERY + 1, TRAIN_STEPS + 1)]:
        problems.append(f"losses {losses.tolist()} vs {train['losses']}")
    if len(steps) != job_steps:
        problems.append(f"{len(steps)} steps run, want {job_steps}")
    for i, (_, got, by) in enumerate(steps):
        got = {k: v for k, v in got.items() if v}
        if got != want or any(by[k] != v for k, v in want_routes.items()):
            problems.append(f"step {i + 1}: launches {got} routes {by}")
    if total != {k: v * job_steps for k, v in want.items()}:
        problems.append(f"job launches {total}")
    if sum(plain_calls.values()):
        problems.append(f"a plain version ran: {plain_calls}")
    # The first attempt's state is ~11 GiB; 512 MiB of slack covers what a
    # new thread's cuBLAS handle keeps (its 32 MiB workspace).
    if second["allocated_at_start"] > first["allocated_at_start"] + 2 ** 29:
        problems.append("the first attempt's tensors were still allocated")
    if alive:
        problems.append(f"threads alive after shutdown: {alive}")
    if problems:
        raise AssertionError("job: " + "; ".join(problems))
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 10: Zamba2 training -- the SSD backward, f32 parity, full width
# ---------------------------------------------------------------------------

# The SSD backward against its plain version: Zamba2's training shape (B 8,
# S 1024, H 64, N = P = 64, chunk 128), ragged last chunks (S 1000: 104
# rows; S 200: 72), and chunk 16 at B 1 under strong decay with a nonzero
# dh_final: (label, (B, S, chunk, dt_scale, dh_final given)).
SSD_BWD_CASES = (("train", (8, 1024, Z_CHUNK, 1.0, False)),
                 ("ragged S 1000", (8, 1000, Z_CHUNK, 1.0, False)),
                 ("ragged S 200", (8, 200, Z_CHUNK, 1.0, False)),
                 ("chunk 16, B 1, strong decay, dh_final",
                  (1, 512, 16, 20.0, True)))
# zamba2-1.2b's training run: batch 8 x 1024 (8 SSD chunks of 128), 4
# steps, checkpoints every 2; the second run is revoked after step 3,
# loses it and resumes from the step-2 checkpoint (5 steps run).
ZT_B, ZT_S = 8, 1024
ZT_STEPS, ZT_EVERY, ZT_REVOKE = 4, 2, 3


def _ssd_bwd_case(gen, dev, dtype, b, s, chunk, dt_scale=1.0, with_dh=False,
                  h=Z_SSM_H):
    """(kernel, plain, inputs) of one SSD backward at the Zamba2 widths (H
    64, or ``h`` heads): ``_ssd_case``'s inputs, a cotangent dy of order 1
    and, if ``with_dh``, one for h_final."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    args = ((rn(b, s, h, Z_P) / dt_scale).to(dtype),
            F.softplus(rn(b, s, h)) * dt_scale, 0.5 * rn(h),
            (rn(b, s, Z_N) * Z_N ** -0.5).to(dtype),
            (rn(b, s, Z_N) * Z_N ** -0.5).to(dtype),
            rn(b, s, h, Z_P).to(dtype),
            rn(b, h, Z_N, Z_P) if with_dh else None)
    return (lambda: K.ssd_scan_bwd(*args, chunk=chunk),
            lambda: K.ssd_chunked_backward_reference(*args, chunk=chunk),
            args)


def _ssd_bwd_bound(b, s, h, p, n, chunk, dtype_bytes):
    """(bytes, flops) of an SSD backward: x and dy read and dx written, B
    and C read and dB, dC written, in the dtype; dt read, ddt written, a_log
    and da_log (f32). Flops a (batch, head, chunk of L): five L x N x P
    products (the recomputed state, dy h^T for dC's state term, B dh for
    dx's, x dh^T for dB's, the dh update) and four causal L x L products
    (W^T dy, dy x^T, Q B, Q^T C), 2 flops a multiply-add; C B^T once a
    (batch, chunk)."""
    nbytes = 3 * b * s * h * p * dtype_bytes + 4 * b * s * n * dtype_bytes \
        + 2 * b * s * h * 4 + 2 * h * 4
    flops = 0.0
    for c0 in range(0, s, chunk):
        ln = min(chunk, s - c0)
        tri = ln * (ln + 1) // 2
        flops += b * h * (10.0 * ln * n * p + 4.0 * tri * (p + n)) \
            + b * 2.0 * tri * n
    return nbytes, flops


def _ssd_bwd_kernels():
    """``ssd_scan_bwd`` against ``ssd_chunked_backward_reference`` on the
    same inputs at ``SSD_BWD_CASES`` in bf16 and f32, each call twice, bit
    for bit the same, on its dtype's route (bf16 ``sm90``, f32
    ``cuda_core``); bf16 outputs (dx, dB, dC) within TOL_BF16 and f32 ones
    (ddt and da_log in both dtypes) within TOL_F32 of each gradient's max
    |value|. The training shape timed in bf16 (and f32)
    beside the plain version and the bound; no library call computes it.
    Outside deterministic mode: the plain version takes CUDA's cumsum."""
    import torch
    from repro_torch import kernels as K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    rec = {"max_abs_err": {}}
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for label, (b, s, chunk, dt_scale, with_dh) in SSD_BWD_CASES:
            kern, plain, args = _ssd_bwd_case(gen, dev, dtype, b, s, chunk,
                                              dt_scale, with_dh)
            route = "sm90" if kind == "bf16" else "cuda_core"
            K.reset_launch_counts()
            got, again = kern(), kern()
            torch.cuda.synchronize()
            routes = K.launch_counts_by_route()["ssd_scan_bwd"]
            if routes != {"sm90": 2 * (route == "sm90"),
                          "cuda_core": 2 * (route == "cuda_core")} \
                    or sum(K.launch_counts().values()) != 2:
                raise AssertionError(f"ssd_scan_bwd {kind} {label}: "
                                     f"launches {K.launch_counts()}, routes "
                                     f"{routes}")
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            errs = [_rel_err(x, y) for x, y in zip(got, plain())]
            tols = [TOL_BF16 if x.dtype == torch.bfloat16 else TOL_F32
                    for x in got]
            ok = same and all(math.isfinite(e) and e <= t
                              for e, t in zip(errs, tols))
            log(f"[zamba train] ssd_scan_bwd {kind} {label} (B {b}, S {s}, "
                f"chunk {chunk}) on {route}: max|kernel-plain|/max|plain| "
                f"dx, ddt, da_log, dB, dC {['%.2e' % e for e in errs]} "
                f"(tol {tols}), repeat bitwise {same} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"ssd_scan_bwd {kind} {label} "
                                     f"disagrees: {errs}, repeat {same}")
            rec["max_abs_err"][kind] = max(rec["max_abs_err"].get(kind, 0.0),
                                           max(errs))
            if label != "train":
                continue
            nbytes, flops = _ssd_bwd_bound(b, s, Z_SSM_H, Z_P, Z_N, chunk,
                                           args[0].element_size())
            peak = BF16_FLOPS_PER_S if kind == "bf16" else F32_FLOPS_PER_S
            bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / peak
            # one plain call a timing: its ~500 launches a call fill the
            # launch queue behind the spin at three
            rec[kind] = {"ms": time_ms(kern, iters=10),
                         "plain_ms": time_ms(plain, iters=1, warmup=1),
                         "bound_ms": max(bytes_s, ops_s) * 1e3,
                         "bound_by": ("bytes" if bytes_s >= ops_s
                                      else "operations"),
                         "bytes": nbytes, "flops": flops,
                         "split_ms": _device_split(kern),
                         "shape": [b, s, Z_SSM_H, Z_P, Z_N, chunk]}
            r = rec[kind]
            log(f"[zamba train] ssd_scan_bwd {kind} (B {b}, S {s}, H "
                f"{Z_SSM_H}, N = P = {Z_P}, chunk {chunk}): kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {nbytes / 1e6:.1f}"
                f" MB, {flops / 1e9:.1f} GFLOP), no library call; device ms "
                f"a call by kernel (profiler) "
                f"{ {k: round(v, 4) for k, v in r['split_ms'].items()} }")
            del got, again
        torch.cuda.empty_cache()
    return rec


def _zamba_bwd_shapes(cfg):
    """The other backward kernels of a Zamba2 training step at its own
    shapes, bf16, through ``_bwd_twice``: RMSNorm's over ZT_B x ZT_S rows
    at D 2 ``d_model`` (each Mamba layer's ``gate_norm``) and ``d_model``
    (its ``norm``, the shared block's two and ``final_norm``), f32 weights
    away from one, on the register kernel; flash attention at B ZT_B, S
    ZT_S, H = KV = ``num_heads``, hd ``head_dim``, causal (the shared
    block) on sm90. -> {kernel: {shape: max error}}."""
    import torch
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_path
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    rows = ZT_B * ZT_S
    out = {"rmsnorm_bwd": {}, "flash_attention_bwd": {}}
    for d in (cfg.ssm_expand * cfg.d_model, cfg.d_model):
        if rmsnorm_path(d, torch.bfloat16) != "registers":
            raise AssertionError(f"zamba train: RMSNorm at D {d} leaves the "
                                 f"register kernel")
        kern, plain, _ = _rms_bwd_case(gen, dev, torch.bfloat16, rows, d,
                                       w_mean=0.25, w_std=0.05)
        out["rmsnorm_bwd"][f"{rows}x{d}"] = _bwd_twice(
            "zamba train", "rmsnorm_bwd", f"bf16 {rows}x{d}", "registers",
            kern, plain)
    shape = (ZT_B, ZT_S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    kern, plain, _ = _flash_bwd_case(gen, dev, torch.bfloat16, *shape)
    out["flash_attention_bwd"][str(shape)] = _bwd_twice(
        "zamba train", "flash_attention_bwd", f"bf16 {shape} causal", "sm90",
        kern, plain)
    del kern, plain
    torch.cuda.empty_cache()
    return out


def _zamba_step_launches(cfg) -> dict:
    """A training step's launches with remat "full": each Mamba layer's SSD
    scan and its two norms run again in its recompute; the shared block
    (its two norms and flash) runs once an application, outside the remat,
    and ``final_norm`` once."""
    from repro_torch.models import get_family
    L, apps = cfg.num_layers, get_family(cfg).n_shared_applications(cfg)
    return {"ssd_scan": 2 * L, "ssd_scan_bwd": L,
            "flash_attention_fwd": apps, "flash_attention_bwd": apps,
            "rmsnorm_fused": 4 * L + 2 * apps + 1,
            "rmsnorm_bwd": 2 * L + 2 * apps + 1}


def _revoked_train(cfg, label, want, want_routes, smi, *, batch, seq,
                   steps, every, revoke_step, source=_corpus_source):
    """Full-width, full-depth ``cfg`` (bf16 compute over f32 masters, remat
    "full", seed 0) trained by ElasticTrainer on batches from ``source``
    (the train phase's synthetic corpus by default; ``_train_run``), batch
    x seq positions, int8 AdamW moments, ``steps`` steps
    with checkpoints every ``every``: once uninterrupted, once revoked
    after step ``revoke_step``, whose work is lost, and resumed from the
    last checkpoint before it, under ``torch.use_deterministic_algorithms``.
    The two final states' SHA-256 equal, the loss falling, every step's
    launches exactly ``want`` (every other kernel none) and, for each
    kernel of ``want_routes``, by route, and no plain version called."""
    import statistics as st
    import torch
    from repro_torch.models import count_params
    from repro_torch.train import AdamWConfig
    assert cfg.remat == "full" and cfg.param_dtype == "float32"
    assert revoke_step % every != 0
    opt = AdamWConfig(learning_rate=TRAIN_LR, warmup_steps=2,
                      decay_steps=100, state_dtype="int8")
    run_kw = dict(batch=batch, seq=seq, steps=steps, every=every,
                  revoke_step=revoke_step, source=source)
    plain_calls, undo = _plain_call_counter()
    torch.use_deterministic_algorithms(True)
    try:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _GpuSampler() as gpu:
            t0 = time.perf_counter()
            ref, ref_rep, ref_probe, ref_ck = _train_run(cfg, opt, False,
                                                         **run_kw)
            peak = torch.cuda.max_memory_allocated()
            ref_wall = time.perf_counter() - t0
            t1 = time.perf_counter()
            digest = _state_digest(ref.final_state)
            digest_s = time.perf_counter() - t1
            del ref
            gc.collect()
            torch.cuda.empty_cache()
            rev, rev_rep, rev_probe, rev_ck = _train_run(cfg, opt, True,
                                                         **run_kw)
            rev_digest = _state_digest(rev.final_state)
            del rev
            gc.collect()
    finally:
        torch.use_deterministic_algorithms(False)
        undo()
    step_s = [dt for dt, _, _ in ref_probe.steps]
    steady = st.median(step_s[1:])
    clocks = {"uninterrupted": gpu.during(ref_probe.windows),
              "revoked": gpu.during(rev_probe.windows)}
    saves = [e for e in ref_ck + rev_ck if e[0] == "save"]
    restores = [e for e in rev_ck if e[0] == "restore"]
    rec = {"config": cfg.name, "layers": cfg.num_layers,
           "params": count_params(cfg), "batch": batch, "seq": seq,
           "steps": steps, "revoked_at": revoke_step,
           "resumed_from": revoke_step - revoke_step % every,
           "state_dtype": "int8",
           "losses": {str(k): v for k, v in ref_rep.losses.items()},
           "step_ms": [x * 1e3 for x in step_s],
           "step_ms_median_after_first": steady * 1e3,
           "revoked_run_step_ms": [dt * 1e3 for dt, _, _ in rev_probe.steps],
           "gpu_during_steps": clocks,
           "tokens_per_s": batch * seq / steady,
           "max_memory_allocated_bytes": peak, "uninterrupted_run_s": ref_wall,
           "checkpoint_gb": saves[0][3] / 1e9,
           "save_s": [e[2] for e in saves],
           "restore_s": [e[2] for e in restores],
           "launches_per_step": want,
           "launches_by_route_per_step": want_routes,
           "launches": _run_launches(ref_probe),
           "launches_by_route": {
               k: {r: sum(step[2][k][r] for step in ref_probe.steps)
                   for r in by} for k, by in want_routes.items()},
           "revoked_run_launches": _run_launches(rev_probe),
           "steps_run_revoked": rev_rep.steps_run, "state_sha256": digest,
           "digest_s": digest_s, "bitwise_restart": digest == rev_digest}
    log(f"[{label}] {cfg.name} {cfg.num_layers} layers "
        f"({rec['params'] / 1e6:.1f} M params), bf16 over f32 masters, remat"
        f" full, int8 moments, B {batch} x S {seq}: losses "
        f"{[round(x, 4) for x in ref_rep.losses.values()]}; step ms "
        f"{[round(x * 1e3, 1) for x in step_s]} (median after the first "
        f"{steady * 1e3:.1f} ms = {rec['tokens_per_s']:.0f} tokens/s); peak "
        f"device memory {peak / 2**30:.2f} GiB; checkpoint "
        f"{rec['checkpoint_gb']:.2f} GB: saves "
        f"{[round(e[2], 2) for e in saves]} s, restore "
        f"{[round(e[2], 2) for e in restores]} s; digest {digest_s:.1f} s; "
        f"revoked after step {revoke_step}, resumed from step "
        f"{rec['resumed_from']}, {rev_rep.steps_run} steps run: state "
        f"SHA-256 {digest[:16]}... equal: {rec['bitwise_restart']}; launches "
        f"a step {want}; the revoked run's step ms "
        f"{[round(x, 1) for x in rec['revoked_run_step_ms']]}; "
        f"{_clock_text(clocks)}; on {smi}")
    for run, rep, probe in (("uninterrupted", ref_rep, ref_probe),
                            ("revoked", rev_rep, rev_probe)):
        for i, (_, counts, routes) in enumerate(probe.steps):
            got = {k: v for k, v in counts.items() if v}
            if got != want or any(routes[k] != v
                                  for k, v in want_routes.items()):
                raise AssertionError(f"{label} {run} step {i + 1}: launches "
                                     f"{got} routes {routes}, want {want} "
                                     f"{want_routes}")
        if not rep.losses[steps] < rep.losses[1]:
            raise AssertionError(f"{label} {run}: loss did not fall "
                                 f"{rep.losses}")
    if sum(plain_calls.values()):
        raise AssertionError(f"{label}: a plain version ran on the card: "
                             f"{plain_calls}")
    if rev_rep.restarts != 1 \
            or rev_rep.steps_run != steps + revoke_step % every \
            or digest != rev_digest:
        raise AssertionError(f"{label}: the revoked run's final state is not "
                             "bit for bit the uninterrupted run's")
    torch.cuda.empty_cache()
    return rec


def _zamba_bf16_step(cfg):
    """``_zamba_step_launches`` and, by route, a bf16 step's: SSD scans and
    their backward, flash forward and backward on sm90, RMSNorm's backward
    on its register kernel."""
    want = _zamba_step_launches(cfg)
    return want, {
        "ssd_scan": {"sm90": want["ssd_scan"], "cuda_core": 0},
        "ssd_scan_bwd": {"sm90": want["ssd_scan_bwd"], "cuda_core": 0},
        "flash_attention_fwd": {"sm90": want["flash_attention_fwd"],
                                "cuda_core": 0},
        "flash_attention_bwd": {"sm90": want["flash_attention_bwd"],
                                "cuda_core": 0},
        "rmsnorm_bwd": {"registers": want["rmsnorm_bwd"], "smem": 0}}


def _zamba_train_run(cfg, smi):
    """Full-width zamba2-1.2b (38 Mamba2 layers, 6 shared applications)
    through ``_revoked_train`` at ZT_B x ZT_S: every step's launches
    exactly ``_zamba_bf16_step``'s."""
    want, want_routes = _zamba_bf16_step(cfg)
    return _revoked_train(cfg, "zamba train", want, want_routes, smi,
                          batch=ZT_B, seq=ZT_S, steps=ZT_STEPS,
                          every=ZT_EVERY, revoke_step=ZT_REVOKE)


def _step_profile(cfg, label, batch, smi):
    """One full-width training step of ``cfg`` on ``batch`` (host numpy
    arrays, moved to the card; int8 moments, seed 0) through
    ``launch/profile_serve.py``'s ``profile`` (a warm-up step, one timed
    without the profiler, one under ``torch.profiler``): the device busy
    share of the step's wall, the ten kernels with the most device time,
    and the port's backward kernels' device time by family."""
    import torch
    from repro_torch.launch.profile_serve import profile
    from repro_torch.train import AdamWConfig, ElasticTrainer
    opt = AdamWConfig(learning_rate=TRAIN_LR, warmup_steps=2,
                      decay_steps=100, state_dtype="int8")
    trainer = ElasticTrainer(cfg, opt, None, seed=0, device="cuda")
    params, opt_state = trainer.init_state()
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    state = [params, opt_state]

    def step():
        state[0], state[1], _ = trainer._step_fn(state[0], state[1], batch)

    prof = profile(step)
    if not prof["kernels"] or prof["device_ms"] <= 0:
        raise AssertionError(f"{label} profile: the profiler saw no device "
                             f"kernel")
    top = [dict(k, name=k["name"][:90]) for k in prof["kernels"][:10]]
    bwd = {fam: sum(k["device_ms"] for k in prof["kernels"]
                    if fam in k["name"])
           for fam in ("ssd_bwd", "flash_bwd", "rmsnorm_bwd")}
    rec = {**{k: prof[k] for k in ("wall_ms", "wall_profiled_ms",
                                   "device_ms", "busy_share", "launches")},
           "ssd_bwd_ms": bwd["ssd_bwd"], "backward_kernels_ms": bwd,
           "top_kernels": top}
    log(f"[{label}] profiled step of {cfg.name}: wall "
        f"{rec['wall_ms']:.1f} ms unprofiled, device kernels "
        f"{rec['device_ms']:.1f} ms, busy share {rec['busy_share']:.3f}, "
        f"{rec['launches']} launches; the port's backward kernels by "
        f"family { {k: round(v, 2) for k, v in bwd.items() if v} } ms; top "
        f"ten by device time: " + "; ".join(
            f"{k['device_ms']:.2f} ms {k['count']}x {k['name'][:70]}"
            for k in top) + f"; on {smi}")
    del state, params, opt_state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _zamba_step_profile(cfg, smi):
    """One full-width zamba2-1.2b training step as ``_zamba_train_run``
    takes it (B ZT_B x ZT_S tokens from seed 0) through ``_step_profile``;
    its record's ``ssd_bwd_ms`` is the SSD backward's share."""
    import numpy as np
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (ZT_B, ZT_S + 1)).astype(np.int32)
    return _step_profile(cfg, "zamba train", {
        "tokens": np.ascontiguousarray(tokens[:, :-1]),
        "labels": np.ascontiguousarray(tokens[:, 1:])}, smi)


def phase_zamba_train(smi: str):
    """Zamba2 training on the card: the SSD backward kernel against its
    plain version (``_ssd_bwd_kernels``) and RMSNorm's and flash
    attention's backward at the step's shapes (``_zamba_bwd_shapes``);
    then, under ``torch.use_deterministic_algorithms``, Zamba2 widths at
    depth 6 (one Mamba group and one shared application) in f32, B 2, S
    256 at SSD chunk 128 and 96 (a ragged last chunk), ``train_loss`` and every
    gradient card against CPU (the loss within 1e-5, each gradient within
    1e-4 of its leaf's max, launches exact, f32 on the CUDA-core routes);
    and full-width zamba2-1.2b trained with a revocation
    (``_zamba_train_run``), then one such step profiled
    (``_zamba_step_profile``)."""
    import torch
    from repro_torch.configs import get_config
    seconds = {}
    t = time.perf_counter()
    kernels = _ssd_bwd_kernels()
    seconds["ssd backward kernel"] = time.perf_counter() - t
    t = time.perf_counter()
    cfg = get_config("zamba2-1.2b")
    shapes = _zamba_bwd_shapes(cfg)
    seconds["other backward kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        for chunk in (Z_CHUNK, 96):
            small = cfg.replace(num_layers=6, dtype="float32", ssm_chunk=chunk)
            _train_parity(small, f"zamba2-1.2b chunk {chunk}",
                          want=_zamba_step_launches(small))
    finally:
        torch.use_deterministic_algorithms(False)
    seconds["parity"] = time.perf_counter() - t
    t = time.perf_counter()
    train = _zamba_train_run(cfg, smi)
    seconds["train"] = time.perf_counter() - t
    t = time.perf_counter()
    prof = _zamba_step_profile(cfg, smi)
    seconds["profiled step"] = time.perf_counter() - t
    log(f"[zamba train] seconds a part: "
        f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    return {"ssd_scan_bwd": kernels, "bwd_shapes": shapes, "train": train,
            "profile": prof, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 11: xLSTM -- parity, serve, train and where the time goes
# ---------------------------------------------------------------------------

# xlstm-350m's training run: full width at depth 4 (2 of its 12
# mLSTM/sLSTM pairs), batch 8 x 512 (8 mLSTM chunks of 64), 4 steps, checkpoints
# every 2; the second run is revoked after step 3, loses it and resumes
# from the step-2 checkpoint, so it runs 5 steps and replays one. A step
# at full depth took 15-21 s on an H100 (the sLSTM loop's launches,
# forward, recompute and backward, a pair at a time, bound by the host):
# at depth 12 its 9 steps took 128.8 s of a 1,011 s whole run on an H100
# whose host kept a training step's device busy 0.77 of its wall, so the
# depth was 6, and is 4 since the ssm sharding phase (8e) joined the
# script, to keep it well inside its 1,200 s limit.
XB, XS, X_TRAIN_LAYERS = 8, 512, 4
X_STEPS, X_EVERY, X_REVOKE = 4, 2, 3


def _xlstm_norms(cfg) -> int:
    """RMSNorm launches a pass: mLSTM ``norm`` and ``out_norm`` and sLSTM
    ``norm`` a pair, and ``final_norm``."""
    return 3 * (cfg.num_layers // 2) + 1


def _left_padded(prompts, dev):
    import numpy as np
    import torch
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    return torch.from_numpy(toks).to(dev)


def _xlstm_parity():
    """xlstm-350m widths at depth 2 (one pair), f32, batch 2: prompts of
    256 (four mLSTM chunks of 64) and of 200 (a ragged last chunk of 8),
    prefill and four decode steps, card against CPU within TOL_PARITY;
    then ``train_loss`` and every gradient at B 2, S 256: the loss within
    1e-5 of itself (the tied embedding's unit-variance rows make it ~10^2)
    and each gradient within 1e-4 of its leaf's max."""
    from repro_torch.configs import get_config
    cfg = get_config("xlstm-350m").replace(num_layers=2, dtype="float32")
    counts = _static_parity(cfg, (ZS, 200), "xlstm-350m",
                            kernels=("rmsnorm_fused",))
    if any(counts[k] for k in PAGED + ("flash_attention_fwd", "ssd_scan")):
        raise AssertionError(f"xlstm parity launched an attention or SSD "
                             f"kernel: {counts}")
    _train_parity(cfg, "xlstm-350m", kernels=("rmsnorm_fused",
                                              "rmsnorm_bwd"))


def _xlstm_norm_kernels(cfg):
    """bf16 RMSNorm at the shapes the xLSTM path gives it, with f32 weights
    as the blocks' norms have, against the plain versions on the same
    inputs, each on the register kernel: the forward over the serve
    prefill's 8 x 256 rows and decode's 8 at D ``d_model`` (each block's
    ``norm``) and 2 ``d_model`` (mLSTM's ``out_norm``), within TOL_BF16;
    the backward over a training step's XB x XS rows at both widths,
    within TOL_BF16 of each gradient's max and twice bit for bit."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_path
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    out = {"rmsnorm_fused": {}, "rmsnorm_bwd": {}}
    for d in (cfg.d_model, 2 * cfg.d_model):
        if rmsnorm_path(d, torch.bfloat16) != "registers":
            raise AssertionError(f"xlstm: RMSNorm at D {d} leaves the "
                                 f"register kernel")
        for rows in (ZB * ZS, 8):
            x = torch_randn(gen, dev, rows, d).bfloat16()
            w = 0.25 + 0.05 * torch_randn(gen, dev, d)
            K.reset_launch_counts()
            got = K.rmsnorm_fused(x, w)
            launched = K.launch_counts()["rmsnorm_fused"]
            err = _max_err(got, K.rmsnorm_reference(x, w))
            log(f"[xlstm] rmsnorm_fused bf16 {rows}x{d}: max|kernel-plain| "
                f"{err:.3e} (tol {TOL_BF16}), launches {launched}")
            if launched != 1 or not (math.isfinite(err) and err <= TOL_BF16):
                raise AssertionError(f"xlstm rmsnorm_fused {rows}x{d}: "
                                     f"error {err}, launches {launched}")
            out["rmsnorm_fused"][f"{rows}x{d}"] = err
        kern, plain, _ = _rms_bwd_case(gen, dev, torch.bfloat16, XB * XS, d)
        out["rmsnorm_bwd"][f"{XB * XS}x{d}"] = _bwd_twice(
            "xlstm", "rmsnorm_bwd", f"bf16 {XB * XS}x{d}", "registers", kern,
            plain)
    return out


def _xlstm_serve(cfg, params, smi):
    """Full-width xlstm-350m through the static ServeEngine: the Zamba2
    phase's 8 prompts (160-256 tokens, padded to 256), 32 new tokens each,
    after a warm-up; RMSNorm's launches exactly ``_xlstm_norms`` a pass
    over 1 + 32 passes, nothing else, no plain version. Then untimed at a
    longest prompt of 200 (mLSTM chunks 64 x 3 + 8), 8 new tokens."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.prompts import static_batch_prompts
    prompts = static_batch_prompts(cfg.vocab_size)
    max_new = 32
    norms = _xlstm_norms(cfg)
    eng = ServeEngine(cfg, params, max_len=SERVE_MAX_LEN, device="cuda")
    plain_calls, undo = _plain_call_counter()
    try:
        eng.generate(prompts, max_new=2)                 # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new=max_new)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        ragged = [p[:200] for p in prompts]
        reset_launch_counts()
        rtoks = eng.generate(ragged, max_new=8).tokens
        torch.cuda.synchronize()
        rcounts = launch_counts()
    finally:
        undo()
    got = {k: v for k, v in counts.items() if v}
    rgot = {k: v for k, v in rcounts.items() if v}
    want = {"rmsnorm_fused": norms * (1 + max_new)}
    if got != want or rgot != {"rmsnorm_fused": norms * (1 + 8)} \
            or sum(plain_calls.values()):
        raise AssertionError(f"xlstm serve launches {got} and at 200 {rgot},"
                             f" want {want}; plain calls {plain_calls}")
    for toks, n, what in ((out.tokens, max_new, "timed"),
                          (rtoks, 8, "longest prompt 200")):
        if toks.shape != (len(prompts), n) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"xlstm serve {what}: bad tokens "
                                 f"{toks.shape}")
    rec = {"prompts": len(prompts), "padded_to": max(map(len, prompts)),
           "max_new": max_new, "generate_s": dt,
           "tokens_per_s": out.tokens.size / dt,
           "max_memory_allocated_bytes": peak,
           "launches": got, "launches_at_200": rgot}
    log(f"[xlstm] serve: xlstm-350m {cfg.num_layers} layers bf16, static "
        f"engine: {len(prompts)} prompts (padded to {rec['padded_to']}) x "
        f"{max_new} new in {dt:.3f} s = {rec['tokens_per_s']:.1f} tok/s "
        f"(prefill+decode), peak device memory {peak / 2**30:.2f} GiB, "
        f"launches {got} ({norms} a pass, all on the register kernel); "
        f"longest prompt 200, 8 new: launches {rgot}; on {smi}")
    del eng
    return rec


def _xlstm_profile(cfg, params, smi):
    """Where a full-width prefill of 8 x 256 and one decode step spend
    their time: ``launch/profile_serve.py``'s ``profile`` of each (the
    unprofiled wall, the device kernels' time and launches under
    ``torch.profiler``, their share of that wall, the kernels by device
    time), and the wall share inside ``slstm_scan`` (its calls bracketed
    by synchronises, in a run of its own)."""
    import torch
    from repro_torch.launch.profile_serve import profile
    from repro_torch.models import get_family
    from repro_torch.models import xlstm as X
    from repro_torch.serve.prompts import static_batch_prompts
    fam = get_family(cfg)
    toks = _left_padded(static_batch_prompts(cfg.vocab_size), "cuda")
    logits, cache = fam.prefill(cfg, params, {"tokens": toks})
    step = {"tokens": logits.argmax(-1)[:, None],
            "pos": torch.full((toks.shape[0],), toks.shape[1],
                              dtype=torch.int32, device="cuda")}
    calls = {f"prefill {toks.shape[0]} x {toks.shape[1]}":
             lambda: fam.prefill(cfg, params, {"tokens": toks}),
             "decode step": lambda: fam.decode(cfg, params, step, cache)}
    scan = X.slstm_scan
    inside = []

    def timed_scan(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = scan(*a, **kw)
        torch.cuda.synchronize()
        inside.append(time.perf_counter() - t)
        return out

    rec = {}
    for name, fn in calls.items():
        with torch.no_grad():
            prof = profile(fn)
            X.slstm_scan = timed_scan
            try:
                inside.clear()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_scan = time.perf_counter() - t0
            finally:
                X.slstm_scan = scan
        if not prof["kernels"] or prof["device_ms"] <= 0:
            raise AssertionError(f"xlstm profile {name}: the profiler saw no "
                                 f"device kernel")
        rec[name] = r = {
            **{k: prof[k] for k in ("wall_ms", "device_ms", "busy_share",
                                    "launches")},
            "launches_per_layer_pair": prof["launches"]
            / (cfg.num_layers // 2),
            "slstm_scan_wall_share": sum(inside) / wall_scan,
            "slstm_scan_ms": sum(inside) * 1e3,
            "top_kernels": [dict(k, name=k["name"][:90])
                            for k in prof["kernels"][:8]]}
        log(f"[xlstm] profile {name}: wall {r['wall_ms']:.2f} ms "
            f"unprofiled, device kernels {r['device_ms']:.2f} ms (busy "
            f"share {r['busy_share']:.3f}), {r['launches']} kernel launches; "
            f"inside slstm_scan's time loop {r['slstm_scan_ms']:.2f} ms = "
            f"{r['slstm_scan_wall_share']:.3f} of the wall (a run with its "
            f"calls bracketed by synchronises, {wall_scan * 1e3:.2f} ms); "
            f"top kernels: " + "; ".join(
                f"{k['device_ms']:.3f} ms {k['count']}x {k['name'][:60]}"
                for k in r["top_kernels"]) + f"; on {smi}")
    del cache
    return rec


def _xlstm_train(cfg, smi):
    """xlstm-350m at full width through ``_revoked_train`` at XB x XS,
    X_STEPS steps with checkpoints every X_EVERY, revoked after X_REVOKE
    (and replayed from the checkpoint before it): every
    step's launches exact -- RMSNorm forward 2 (3P) + 1 (each pair's three
    norms run again in its recompute, ``final_norm`` once) and backward 3P
    + 1, every backward on its register kernel, P pairs."""
    want, want_routes = _xlstm_step_launches(cfg)
    return _revoked_train(cfg, "xlstm train", want, want_routes,
                          smi, batch=XB, seq=XS, steps=X_STEPS,
                          every=X_EVERY, revoke_step=X_REVOKE)


def _xlstm_step_launches(cfg):
    """An xLSTM training step's launches and launches by route (RMSNorm
    alone, its backward on the register kernel)."""
    norms = _xlstm_norms(cfg)
    return ({"rmsnorm_fused": 2 * (norms - 1) + 1, "rmsnorm_bwd": norms},
            {"rmsnorm_bwd": {"registers": norms, "smem": 0}})


def phase_xlstm(smi: str):
    """xlstm-350m on the card: f32 parity against the CPU (serve and
    train) at depth 2; bf16 RMSNorm against its plain version at the
    path's shapes; then the full model (24 layers, 12 pairs, bf16,
    random weights from seed 0) served through the static ServeEngine
    with exact RMSNorm launches, profiled (a prefill of 8 x 256 and one
    decode step), and trained with a revocation, bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_family, init_params
    seconds = {}
    t = time.perf_counter()
    _xlstm_parity()
    seconds["parity"] = time.perf_counter() - t
    cfg = get_config("xlstm-350m")
    t = time.perf_counter()
    norm_errs = _xlstm_norm_kernels(cfg)
    seconds["norm kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    params = init_params(cfg, get_family(cfg).layout(cfg), seed=0,
                         device="cuda")
    serve = _xlstm_serve(cfg, params, smi)
    seconds["serve"] = time.perf_counter() - t
    t = time.perf_counter()
    profile = _xlstm_profile(cfg, params, smi)
    seconds["profile"] = time.perf_counter() - t
    del params
    torch.cuda.empty_cache()
    t = time.perf_counter()
    train = _xlstm_train(cfg.replace(num_layers=X_TRAIN_LAYERS), smi)
    seconds["train"] = time.perf_counter() - t
    log(f"[xlstm] seconds a part: "
        f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    return {"norm_kernels": norm_errs, "serve": serve, "profile": profile,
            "train": train, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 12: the audio and VLM frontends
# ---------------------------------------------------------------------------

def _frontend_parity():
    """hubert-xlarge and paligemma-3b at full width and depth 2 in f32, card
    (kernels) against CPU (plain versions) on the same weights: hubert's
    encode logits over B 2 x 200 frames; paligemma's prefill of B 2 x (256
    patches + 16 tokens), then three decode steps from pos 272 over the
    cache grown by 8 rows, logits and every cache row within TOL_PARITY.
    Every flash launch on the CUDA-core route (hd 80 and 256); RMSNorm
    launched."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import (launch_counts, launch_counts_by_route,
                                     reset_launch_counts)
    from repro_torch.models import get_family, init_params
    from repro_torch.train import (build_decode_step, build_encode_step,
                                   build_prefill_step)
    rng = np.random.RandomState(0)
    worst = {}

    def check(kind, got, want):
        err = (got.float().cpu() - want.float()).abs().max().item()
        worst[kind] = max(err, worst.get(kind, 0.0))
        if not math.isfinite(err) or err > TOL_PARITY:
            raise AssertionError(f"frontend parity {kind}: max|diff| {err}")

    reset_launch_counts()
    cfg = get_config("hubert-xlarge").replace(num_layers=2, dtype="float32")
    gpu = init_params(cfg, get_family(cfg).layout(cfg), seed=0,
                      device="cuda")
    params = {"cuda": gpu, "cpu": _to(gpu, "cpu")}
    frames = torch.from_numpy(rng.randn(2, 200, cfg.frontend_dim).astype(
        np.float32))
    encode = build_encode_step(cfg)
    got = {d: encode(params[d], {"frames": frames.to(d)})
           for d in ("cuda", "cpu")}
    check("hubert-xlarge encode logits", got["cuda"], got["cpu"])
    del gpu, params

    cfg = get_config("paligemma-3b").replace(num_layers=2, dtype="float32")
    fam = get_family(cfg)
    gpu = init_params(cfg, fam.layout(cfg), seed=0, device="cuda")
    params = {"cuda": gpu, "cpu": _to(gpu, "cpu")}
    batch = {"patches": torch.from_numpy(rng.randn(
                 2, cfg.frontend_len, cfg.frontend_dim).astype(np.float32)),
             "tokens": torch.from_numpy(rng.randint(
                 0, cfg.vocab_size, (2, 16)))}
    prefill, decode = build_prefill_step(cfg), build_decode_step(cfg)
    rows = cfg.frontend_len + 16
    logits, caches = {}, {}
    for d in ("cuda", "cpu"):
        logits[d], cache = prefill(params[d],
                                   {k: v.to(d) for k, v in batch.items()})
        caches[d] = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 8))
                     for k, v in cache.items()}
    check("paligemma-3b patch prefill logits", logits["cuda"], logits["cpu"])
    cur = logits["cpu"].argmax(-1)
    for step in range(3):
        pos = torch.full((2,), rows + step, dtype=torch.int32)
        for d in ("cuda", "cpu"):
            _, logits[d], caches[d] = decode(
                params[d], {"tokens": cur[:, None].to(d), "pos": pos.to(d)},
                caches[d])
        check("paligemma-3b decode logits", logits["cuda"], logits["cpu"])
        cur = logits["cpu"].argmax(-1)
    for got, want in zip(_leaves(caches["cuda"]), _leaves(caches["cpu"])):
        check("paligemma-3b cache", got, want)
    counts = launch_counts()
    flash = launch_counts_by_route()["flash_attention_fwd"]
    # hubert: 2 layers; paligemma: 2 in its prefill (decode reads the dense
    # cache in plain PyTorch, as the reference's jnp does)
    if flash != {"sm90": 0, "cuda_core": 4} or counts["rmsnorm_fused"] < 1:
        raise AssertionError(f"frontend parity launches {counts}, flash by "
                             f"route {flash}: expected 4 on cuda_core")
    for kind, err in worst.items():
        log(f"[frontends] parity, 2 layers, f32: {kind} max|card-cpu| "
            f"{err:.3e} (tol {TOL_PARITY})")
    del gpu, params, caches
    torch.cuda.empty_cache()
    return worst


def _profile_breakdown(label, fn, smi):
    """``launch/profile_serve.py``'s ``profile`` of ``fn`` (warm-up, an
    unprofiled wall, a run under ``torch.profiler``), with the port's
    kernels' device time beside the rest and the top kernels."""
    import torch
    from repro_torch.launch.profile_serve import PORT_KERNELS, profile
    with torch.no_grad():
        prof = profile(fn)
    if not prof["kernels"] or prof["device_ms"] <= 0:
        raise AssertionError(f"{label} profile: the profiler saw no device "
                             f"kernel")
    port = {}
    for k in prof["kernels"]:
        frag = next((w for w in PORT_KERNELS if w in k["name"]), None)
        if frag is not None:
            port[k["name"][:60]] = k["device_ms"]
    rec = {**{k: prof[k] for k in ("wall_ms", "device_ms", "busy_share",
                                   "launches")},
           "port_kernels_ms": port,
           "top_kernels": [dict(k, name=k["name"][:90])
                           for k in prof["kernels"][:6]]}
    log(f"[frontends] profile {label}: wall {rec['wall_ms']:.2f} ms "
        f"unprofiled, device kernels {rec['device_ms']:.2f} ms (busy share "
        f"{rec['busy_share']:.3f}), {rec['launches']} launches; the port's "
        f"kernels {sum(port.values()):.2f} ms ({port}); top: " + "; ".join(
            f"{k['device_ms']:.2f} ms {k['count']}x {k['name'][:60]}"
            for k in rec["top_kernels"]) + f"; on {smi}")
    return rec


def _exact_launches(label, want, flash_routes=None):
    """Hold the launches since the last reset to ``want`` (every other
    kernel at 0) and, where given, flash's by route; return the counts."""
    from repro_torch.kernels import launch_counts, launch_counts_by_route
    counts = launch_counts()
    full = dict.fromkeys(counts, 0)
    full.update(want)
    flash = launch_counts_by_route()["flash_attention_fwd"]
    if counts != full or (flash_routes is not None and flash != flash_routes):
        raise AssertionError(f"{label}: launches {counts}, flash by route "
                             f"{flash}; expected {full}, flash "
                             f"{flash_routes}")
    return counts


def _hubert_encode(smi):
    """Full hubert-xlarge (48 layers, bf16, random weights from seed 0):
    ``build_encode_step`` over HB_B x HB_S frames after a warm-up, timed
    on the host clock around work that ends in a synchronise; its launches
    exact (flash 48 on sm90 at hd 80, RMSNorm 2L + 1), logits finite."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import get_family, init_params
    from repro_torch.train import build_encode_step
    cfg = get_config("hubert-xlarge")
    params = init_params(cfg, get_family(cfg).layout(cfg), seed=0,
                         device="cuda")
    n_params = _param_count(params)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    frames = torch.randn(HB_B, HB_S, cfg.frontend_dim, generator=gen,
                         device="cuda")
    encode = build_encode_step(cfg)
    encode(params, {"frames": frames})                 # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = encode(params, {"frames": frames})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = cfg.num_layers
    counts = _exact_launches(
        "hubert encode", {"flash_attention_fwd": n,
                          "rmsnorm_fused": 2 * n + 1},
        {"sm90": n, "cuda_core": 0})
    if logits.shape != (HB_B, HB_S, cfg.vocab_size) \
            or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"hubert encode: logits {tuple(logits.shape)} "
                             f"not finite or misshapen")
    peak = torch.cuda.max_memory_allocated()
    rec = {"params": n_params, "batch": [HB_B, HB_S], "seconds": dt,
           "frames_per_s": HB_B * HB_S / dt, "launches": counts,
           "max_memory_allocated_bytes": peak,
           "profile": _profile_breakdown(
               f"hubert-xlarge encode {HB_B} x {HB_S}",
               lambda: encode(params, {"frames": frames}), smi)}
    log(f"[frontends] hubert-xlarge {n} layers bf16 ({n_params / 1e9:.3f} B "
        f"params): encode {HB_B} x {HB_S} frames in {dt * 1e3:.1f} ms = "
        f"{rec['frames_per_s']:.0f} frames/s, peak {peak / 2**30:.2f} GiB, "
        f"launches {counts} on {smi}")
    del params, logits
    torch.cuda.empty_cache()
    return rec


def _paligemma_serve(smi):
    """Full paligemma-3b (18 layers, bf16, random weights from seed 0): the
    family's prefill of PG_B x (256 patches + PG_TEXT tokens), then PG_NEW
    greedy decode steps from pos 288 over the dense cache, after a
    warm-up, launches exact (flash 18 on sm90 at hd 256, RMSNorm 2L + 1 a
    pass); then ``ServeEngine.generate`` (exact) and
    ``ContinuousBatchingEngine.generate`` (every paged launch on sm90 at
    hd 256, G 8) over the serve phase's 8 text prompts x PG_NEW."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import get_family, init_params
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.prompts import shared_prefix_prompts
    from repro_torch.train import build_decode_step, build_prefill_step
    t_phase = time.perf_counter()
    cfg = get_config("paligemma-3b")
    params = init_params(cfg, get_family(cfg).layout(cfg), seed=0,
                         device="cuda")
    n_params = _param_count(params)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    batch = {"patches": torch.randn(PG_B, cfg.frontend_len, cfg.frontend_dim,
                                    generator=gen, device="cuda"),
             "tokens": torch.randint(0, cfg.vocab_size, (PG_B, PG_TEXT),
                                     generator=gen, device="cuda")}
    prefill, decode = build_prefill_step(cfg), build_decode_step(cfg)
    rows = cfg.frontend_len + PG_TEXT

    def run(new):
        logits, cache = prefill(params, batch)
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, new))
                 for k, v in cache.items()}
        cur, out = logits.argmax(-1), []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for step in range(new):
            out.append(cur)
            pos = torch.full((PG_B,), rows + step, dtype=torch.int32,
                             device="cuda")
            cur, _, cache = decode(params, {"tokens": cur[:, None],
                                            "pos": pos}, cache)
        torch.cuda.synchronize()
        return torch.stack(out, 1), time.perf_counter() - t1

    run(2)                                             # warm-up
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks, decode_s = run(PG_NEW)
    dt = time.perf_counter() - t0
    n = cfg.num_layers
    counts = _exact_launches(
        "paligemma patch prefill + decode",
        {"flash_attention_fwd": n, "rmsnorm_fused": (2 * n + 1) * (1 + PG_NEW)},
        {"sm90": n, "cuda_core": 0})
    if toks.shape != (PG_B, PG_NEW) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"paligemma decode: bad tokens {toks.shape}")
    rec = {"params": n_params, "patch_prefill": {
        "batch": [PG_B, cfg.frontend_len, PG_TEXT], "new": PG_NEW,
        "seconds": dt, "prefill_s": dt - decode_s, "decode_s": decode_s,
        "tokens_per_s": PG_B * PG_NEW / dt,
        "decode_tokens_per_s": PG_B * PG_NEW / decode_s,
        "launches": counts,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}}
    log(f"[frontends] paligemma-3b {n} layers bf16 ({n_params / 1e9:.3f} B "
        f"params): prefill {PG_B} x ({cfg.frontend_len} patches + {PG_TEXT} "
        f"tokens) {(dt - decode_s) * 1e3:.1f} ms, {PG_NEW} decode steps "
        f"{decode_s * 1e3:.1f} ms: {rec['patch_prefill']['tokens_per_s']:.1f}"
        f" tok/s, peak "
        f"{rec['patch_prefill']['max_memory_allocated_bytes'] / 2**30:.2f} "
        f"GiB, launches {counts} on {smi}")
    prompts = shared_prefix_prompts(cfg.vocab_size)
    toks, counts, st = _static_run(cfg, params, "paligemma-3b", prompts,
                                   PG_NEW, smi)
    eng = ServeEngine(cfg, params, max_len=SERVE_MAX_LEN, device="cuda")
    rec["static"] = {"seconds": st, "tokens_per_s": toks.size / st,
                     "launches": counts, "profile": _profile_breakdown(
                         f"paligemma-3b static generate 8 x {PG_PROFILE_NEW}",
                         lambda: eng.generate(prompts,
                                              max_new=PG_PROFILE_NEW), smi)}
    del eng
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, counts, by_route, steps, eng = _continuous_run(
        cfg, params, "paligemma-3b", {}, prompts, PG_NEW, smi)
    ct = time.perf_counter() - t0
    paged = {k: by_route[k] for k in PAGED}
    if counts["flash_decode_fwd"] != n * steps \
            or counts["flash_prefill_fwd"] < n or counts["flash_verify_fwd"] \
            or counts["flash_attention_fwd"] or counts["ssd_scan"]:
        raise AssertionError(f"paligemma continuous: launches {counts} for "
                             f"{steps} decode steps")
    rec["continuous"] = {"seconds": ct, "tokens_per_s": toks.size / ct,
                         "decode_steps": steps, "launches": counts,
                         "launches_by_route": paged}
    del eng, params
    rec.update(_end_model_phase("paligemma-3b", t_phase, smi))
    return rec


def phase_frontends(smi: str):
    """The audio and VLM frontends on the card: depth-2 f32 parity against
    the CPU, hubert-xlarge's encode and paligemma-3b's patch prefill,
    decode and both engines at full width and depth."""
    seconds, out = {}, {}
    for name, fn, args in (("parity", _frontend_parity, ()),
                           ("hubert-xlarge", _hubert_encode, (smi,)),
                           ("paligemma-3b", _paligemma_serve, (smi,))):
        t = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = time.perf_counter() - t
    out["seconds"] = seconds
    log(f"[frontends] seconds a part: "
        f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    return out


# ---------------------------------------------------------------------------
# phase 13: training the frontends at full width
# ---------------------------------------------------------------------------

# Each frontend's run: 4 steps with checkpoints every 2; the second run is
# revoked after step 3 (lost, replayed from the step-2 checkpoint).
FT_STEPS, FT_EVERY, FT_REVOKE = 4, 2, 3
# Each frontend at full width and half its depth: at full depth (48 and 18
# layers) the phase took 171.4-178.5 s on an H100, most of it checkpoint
# host work over paligemma-3b's 15.2 GB state; the ssm sharding phase
# (8e) takes its place in the script's 1,200 s.
FT_LAYERS = {"hubert-xlarge": 24, "paligemma-3b": 9}


def _frame_source(store, cfg, batch, seq):
    return _FrameBatches(cfg, batch, seq)


def _patch_source(store, cfg, batch, seq):
    """``_PatchBatches`` over the synthetic corpus at ``cfg``'s vocabulary:
    ``seq`` positions, the first ``frontend_len`` of them patches."""
    return _PatchBatches(_corpus_source(store, cfg, batch,
                                        seq - cfg.frontend_len), cfg, batch)


def phase_frontend_train(smi: str):
    """Full-width hubert-xlarge (``FT_LAYERS``: 24 of its 48 layers, hd
    80, bidirectional; HB_B x HB_S frames with HuBERT's cluster targets,
    ``_FrameBatches``) and paligemma-3b (9 of 18 layers, MQA at hd 256,
    the tied 257,216-token vocabulary; PG_B x (256 patches +
    PG_TRAIN_TEXT tokens of the synthetic corpus), ``_PatchBatches``)
    trained through
    ``_revoked_train``: bf16 over f32 masters, remat "full", int8 moments,
    under ``torch.use_deterministic_algorithms``; FT_STEPS steps, once
    uninterrupted and once revoked after step FT_REVOKE; the final states'
    SHA-256 equal, the loss falling, every step's launches exactly
    ``_transformer_step_launches`` (every flash launch forward and backward
    on sm90, hd 80 on the hd-128 kernels) and no plain version called;
    then one step of each on its first batch profiled (``_step_profile``)."""
    from repro_torch.configs import get_config
    from repro_torch.core import ObjectStore, VirtualClock
    out, seconds = {}, {}
    for name, batch, seq, source in (
            ("hubert-xlarge", HB_B, HB_S, _frame_source),
            ("paligemma-3b", PG_B, 256 + PG_TRAIN_TEXT, _patch_source)):
        cfg = get_config(name).replace(num_layers=FT_LAYERS[name])
        want, want_routes = _transformer_step_launches(cfg)
        t = time.perf_counter()
        out[name] = _revoked_train(
            cfg, "frontend train", want, want_routes, smi, batch=batch,
            seq=seq, steps=FT_STEPS, every=FT_EVERY, revoke_step=FT_REVOKE,
            source=source)
        seconds[name] = time.perf_counter() - t
        t = time.perf_counter()
        first = source(ObjectStore(clock=VirtualClock()), cfg, batch,
                       seq).batch_at(0)
        out[name]["profile"] = _step_profile(cfg, "frontend train", first,
                                             smi)
        seconds[name + " profiled step"] = time.perf_counter() - t
    out["seconds"] = seconds
    log(f"[frontend train] seconds a part: "
        f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    return out


# ---------------------------------------------------------------------------
# phase 14: the examples
# ---------------------------------------------------------------------------

def phase_examples(smi: str):
    """The four examples (``repro_torch.examples``) on the card, each short,
    each held to what it must show: secure_analytics (alice's WOS job
    COMPLETED with topics equal to a numpy count of the same shards, bob
    denied WOS with the deny in the audit, bob's wikipedia job COMPLETED,
    the cold-shard job parked and then COMPLETED, every thread joined);
    quickstart (the loss falls over 10 steps); elastic_training (22
    steps, surviving the revocation at step 20); serve_demo (4 prompts
    answered from weights restored bit for bit from the object store).
    Each launches its kernels on the sm90 route."""
    import numpy as np
    import torch
    from repro_torch.core import JobStatus
    from repro_torch.examples import (elastic_training, quickstart,
                                      secure_analytics, serve_demo)
    from repro_torch.kernels import (launch_counts, launch_counts_by_route,
                                     reset_launch_counts)
    out, seconds = {}, {}

    def started(name):
        reset_launch_counts()
        seconds[name] = time.perf_counter()

    def finished(name, kernels):
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - seconds[name]
        counts, routes = launch_counts(), launch_counts_by_route()
        for k in kernels:
            if counts[k] < 1 or ("sm90" in routes.get(k, {})
                                 and routes[k]["sm90"] != counts[k]):
                raise AssertionError(f"example {name}: {k} launches "
                                     f"{counts[k]}, by route "
                                     f"{routes.get(k)}: not all on sm90")
        return {k: v for k, v in counts.items() if v}

    started("secure_analytics")
    sa = secure_analytics.main(device="cuda")
    status, wos, topics = sa["alice"]
    ids = np.concatenate([np.frombuffer(sa["store"].get(k), dtype=np.int32)
                          for k in wos])
    counts = np.bincount(ids % 97, minlength=97)
    want = [(int(t), int(counts[t]))
            for t in np.lexsort((np.arange(97), -counts))[:5]]
    denied = [(d.principal_id, d.resource) for d in sa["denials"]]
    if status != JobStatus.COMPLETED or topics != repr(want) \
            or denied != [("bob", "dataset/wos/shard-0")] \
            or sa["bob"] != JobStatus.COMPLETED \
            or sa["cold"] != (JobStatus.WAITING_DATA, JobStatus.COMPLETED) \
            or sa["threads_alive"]:
        raise AssertionError(f"secure_analytics: alice {status} {topics} "
                             f"(numpy {want}), denials {denied}, bob "
                             f"{sa['bob']}, cold {sa['cold']}, threads "
                             f"{sa['threads_alive']}")
    finished("secure_analytics", ())
    out["secure_analytics"] = {"topics": want, "denials": denied}

    started("quickstart")
    qs = quickstart.main(device="cuda", steps=10)
    if not qs["losses"][10] < qs["losses"][1]:
        raise AssertionError(f"quickstart: loss did not fall {qs['losses']}")
    out["quickstart"] = {"loss_first": qs["losses"][1],
                         "loss_last": qs["losses"][10],
                         "launches": finished("quickstart", (
                             "flash_attention_fwd", "flash_attention_bwd",
                             "rmsnorm_fused", "rmsnorm_bwd"))}

    started("elastic_training")
    et = elastic_training.main(device="cuda", steps=22)
    rep = et["report"]
    if rep.restarts < 1 or rep.final_step != 22 \
            or not rep.losses[22] < rep.losses[1]:
        raise AssertionError(f"elastic_training: {rep.restarts} revocations, "
                             f"final step {rep.final_step}, losses "
                             f"{rep.losses}")
    out["elastic_training"] = {
        "revoked_steps": et["revoked_steps"], "steps_run": rep.steps_run,
        "loss_first": rep.losses[1], "loss_last": rep.losses[22],
        "launches": finished("elastic_training", (
            "flash_attention_fwd", "flash_attention_bwd", "rmsnorm_fused"))}

    started("serve_demo")
    sd = serve_demo.main(device="cuda")
    same = all(torch.equal(a, b) for a, b in zip(_leaves(sd["params"]),
                                                 _leaves(sd["restored"])))
    if not same or [len(t) for t in sd["tokens"]] != [12] * 4:
        raise AssertionError(f"serve_demo: restored equal {same}, tokens "
                             f"{sd['tokens']}")
    out["serve_demo"] = {"tokens": sd["tokens"],
                         "launches": finished("serve_demo", (
                             "flash_decode_fwd", "flash_prefill_fwd",
                             "rmsnorm_fused"))}
    out["seconds"] = seconds
    log(f"[examples] all four passed on {smi}; seconds "
        f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    torch.cuda.empty_cache()
    return out


def _frontend_train_launches(ft, name) -> dict:
    """A kernel's launches in each frontend training run (uninterrupted)."""
    return {arch: ft[arch]["launches"][name]
            for arch in ("hubert-xlarge", "paligemma-3b")}


def _distributed_launches(dr, name) -> dict:
    """A kernel's launches in each distributed run: the R = 4 rings at
    RING_S and the starcoder2-7b ring step's loss and gradients."""
    out = {f"ring_{tag}_s{RING_S}": r["launches"].get(name, 0)
           for tag, r in dr["rings"].items()}
    out["starcoder2_ring_step"] = \
        dr["starcoder2_step"]["launches"]["ring"].get(name, 0)
    return out


def _sharding_launches(shd, name) -> dict:
    """A kernel's launches in the sharding phase's sharded runs: (a) on the
    one-rank mesh, (b) on rank 0 of the production mesh."""
    return {run: shd[run]["launches"].get(name, 0)
            for run in ("one_rank", "production")}


def _ep_launches(ep, name) -> dict:
    """A kernel's launches in the expert-parallel phase's sharded runs: (a)
    olmoe on the one-rank mesh, (b) olmoe and arctic on rank 0 of the
    production mesh."""
    return {run: ep[run]["launches"].get(name, 0)
            for run in ("one_rank", "olmoe-1b-7b", "arctic-480b")}


def _ssm_launches(ssm, name) -> dict:
    """A kernel's launches in the ssm sharding phase's sharded runs: (a)
    zamba2-1.2b and (c) xlstm-350m on the one-rank mesh, (b) zamba2-1.2b on
    rank 0 of the production mesh."""
    return {run: ssm[run]["launches"].get(name, 0)
            for run in ("zamba_one_rank", "xlstm_one_rank",
                        "zamba_production")}


def _clock_text(clocks: dict) -> str:
    """One run's nvidia-smi samples a step, for a log line."""
    parts = []
    for label, c in clocks.items():
        if not c["samples"]:
            parts.append(f"{label}: no nvidia-smi sample")
            continue
        per = [None if x is None else round(x) for x in c["sm_mhz_per_step"]]
        parts.append(f"{label}: SM MHz a step {per} (median {c['sm_mhz']:.0f}"
                     f"), power median {c['power_w']:.0f} W, temperature max "
                     f"{c['temp_c_max']:.0f} C")
    return "; ".join(parts)


def _state_leaves(state):
    from repro_torch.checkpoint.checkpointer import _flatten
    return [t for _, t in _flatten(state)]


def _state_digest(state) -> str:
    """SHA-256 over every leaf of a (params, optimizer state) tree: its
    name, dtype, shape and bytes, copied to the host a leaf at a time."""
    import hashlib
    import torch
    from repro_torch.checkpoint.checkpointer import _flatten
    h = hashlib.sha256()
    for name, t in _flatten(state):
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# phase 15: distributed -- the ring through the kernels, a ring train step
# ---------------------------------------------------------------------------

# starcoder2-7b's attention width (configs/starcoder2_7b.py): 36 heads of
# 128 over 4 KV heads, the head count a 16-way model axis does not divide.
# The single-device ring cuts RING_S into RING_SHARDS shards (8192 each);
# a plain version cannot hold a 32k x 32k score matrix, so the ring is held
# to the plain versions at RING_S_PLAIN.
RING_H, RING_KV, RING_HD, RING_SHARDS = 36, 4, 128, 4
RING_S, RING_S_PLAIN = 32768, 2048
# starcoder2-7b at full width and depth 2 (of 32), batch 2 x 4096: the
# ring and chunked train steps on a one-process (1, 1) ("data", "model")
# mesh.
SC_DEPTH, SC_B, SC_S = 2, 2, 4096


def _ring_blocks(causal: bool) -> int:
    """The ring's visible blocks: the forward's launches, and the
    backward's; a causal ring skips the R(R-1)/2 blocks in the future."""
    r = RING_SHARDS
    return r * (r + 1) // 2 if causal else r * r


def _ring_grads(q, k, v, dout, causal):
    """(out, dq, dk, dv) of ``ring_attention_single_device``."""
    import torch
    from repro_torch.distributed import ring_attention_single_device
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = ring_attention_single_device(*leaves, shards=RING_SHARDS,
                                       causal=causal)
    return (out.detach(), *torch.autograd.grad(out, leaves, dout))


def _flash_whole(q, k, v, dout, causal):
    """(out, dq, dk, dv) of one flash forward and backward over the whole
    sequence."""
    from repro_torch import kernels as K
    out, lse = K.flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    return (out, *K.flash_attention_bwd(q, k, v, out, dout, lse,
                                        causal=causal))


def _plain_whole(q, k, v, dout, causal):
    from repro_torch import kernels as K
    return (K.attention_reference(q, k, v, causal=causal),
            *K.attention_bwd_reference(q, k, v, dout, causal=causal))


def _ring_case(gen, s, causal, against):
    """The R = 4 ring at sequence ``s`` in bf16: its launches exactly
    ``_ring_blocks`` forward and backward, nothing else; out, dQ, dK and dV
    within TOL_BF16 of ``against``'s (of each one's max) -> (errors,
    launches, inputs)."""
    import torch
    from repro_torch import kernels as K

    def rn(*shape):
        return (0.5 * torch_randn(gen, "cuda", *shape)).to(torch.bfloat16)

    inp = (rn(1, s, RING_H, RING_HD), rn(1, s, RING_KV, RING_HD),
           rn(1, s, RING_KV, RING_HD), rn(1, s, RING_H, RING_HD))
    K.reset_launch_counts()
    got = _ring_grads(*inp, causal)
    torch.cuda.synchronize()
    counts = {k: v for k, v in K.launch_counts().items() if v}
    routes = K.launch_counts_by_route()
    want_counts = {"flash_attention_fwd": _ring_blocks(causal),
                   "flash_attention_bwd": _ring_blocks(causal)}
    errs = [_rel_err(a, b) for a, b in zip(got, against(*inp, causal))]
    on_sm90 = all(routes[k]["sm90"] == n for k, n in want_counts.items())
    ok = counts == want_counts and on_sm90 and all(
        math.isfinite(e) and e <= TOL_BF16 for e in errs)
    log(f"[distributed] ring R {RING_SHARDS} S {s} "
        f"{'causal' if causal else 'full'} vs {against.__name__}: "
        f"max|ring-want|/max|want| out, dq, dk, dv "
        f"{['%.2e' % e for e in errs]} (tol {TOL_BF16}); launches {counts} "
        f"(want {want_counts}, all sm90: {on_sm90}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"distributed ring S {s} causal {causal}: "
                             f"errors {errs}, launches {counts}, routes "
                             f"{routes}")
    return errs, counts, inp


def _ring_timing(inp, causal):
    """Device ms of the ring's forward and of its forward + backward at
    RING_S, beside one whole-sequence flash forward (with the row lse) and
    backward, and the bound of the attention's work (every input read once,
    every output written once; 4 hd flops a visible pair forward, 10
    backward, at the bf16 peak)."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.distributed import ring_attention_single_device
    q, k, v, dout = inp
    s = q.shape[1]
    out, lse = K.flash_attention_fwd(q, k, v, causal=causal, return_lse=True)

    def ring_fwd():
        with torch.no_grad():
            ring_attention_single_device(q, k, v, shards=RING_SHARDS,
                                         causal=causal)

    pairs = RING_H * (s * (s + 1) // 2 if causal else s * s)
    fwd_bytes = 2 * (2 * s * RING_H * RING_HD + 2 * s * RING_KV * RING_HD)
    bwd_bytes, bwd_flops = _flash_bwd_bound(1, s, RING_H, RING_KV, RING_HD,
                                            2, causal=causal)
    rec = {
        "ring_fwd_ms": time_ms(ring_fwd, iters=3, warmup=1),
        "ring_fwd_bwd_ms": time_ms(lambda: _ring_grads(q, k, v, dout,
                                                       causal),
                                   iters=3, warmup=1),
        "flash_fwd_ms": time_ms(lambda: K.flash_attention_fwd(
            q, k, v, causal=causal, return_lse=True), iters=3, warmup=1),
        "flash_bwd_ms": time_ms(lambda: K.flash_attention_bwd(
            q, k, v, out, dout, lse, causal=causal), iters=3, warmup=1),
        "fwd_bound_ms": max(fwd_bytes / HBM_BYTES_PER_S,
                            4.0 * RING_HD * pairs / BF16_FLOPS_PER_S) * 1e3,
        "fwd_bwd_bound_ms": max((fwd_bytes + bwd_bytes) / HBM_BYTES_PER_S,
                                (4.0 * RING_HD * pairs + bwd_flops)
                                / BF16_FLOPS_PER_S) * 1e3}
    return rec


def _counting(module, name, calls):
    """Wrap ``module.name`` to count its calls in ``calls[name]``; returns
    the undo."""
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **kw)
    setattr(module, name, counted)
    return lambda: setattr(module, name, fn)


def _sc_train_step(mesh, smi):
    """starcoder2-7b at full width and depth SC_DEPTH, bf16 over f32 master
    weights, remat full: one ``build_train_step`` step (AdamW, f32 moments)
    and its ``build_loss_and_grads`` with ``attn_impl`` "ring" and
    "chunked", from the same weights (seed 0) and batch, under rules on a
    (1, 1) mesh and deterministic algorithms. The ring runs at R = 1: the
    same kernels in the same order as the chunked path, one block whose
    merge is the block itself, so the losses, every gradient and every
    updated parameter must be equal bit for bit. Every attention call of
    the ring step goes through ``ring_attention_sharded`` (2L with the
    recompute), none of the chunked step's; launches exact; no plain
    version."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.distributed import ShardingRules, activate_rules
    from repro_torch.distributed import ring_attention as ring_mod
    from repro_torch.models import count_params, get_family, init_params
    from repro_torch.models import layers
    from repro_torch.train import AdamWConfig, adamw, build_train_step
    from repro_torch.train.train_step import build_loss_and_grads
    cfg = get_config("starcoder2-7b").replace(num_layers=SC_DEPTH)
    assert cfg.remat == "full" and cfg.num_heads % 16
    fam = get_family(cfg)
    base = init_params(cfg, fam.layout(cfg), seed=0, device="cuda",
                       dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    batch = {n: torch.randint(0, cfg.vocab_size, (SC_B, SC_S), generator=gen,
                              device="cuda") for n in ("tokens", "labels")}
    opt = AdamWConfig(learning_rate=TRAIN_LR, warmup_steps=2,
                      decay_steps=100)
    want, want_routes = _transformer_step_launches(cfg)

    def fresh():
        return adamw.tree_map(lambda p: p.detach().clone().requires_grad_(),
                              base)

    calls = {}
    plain_calls, undo_plain = _plain_call_counter()
    undo = [_counting(layers, "ring_attention_sharded", calls)] + [
        _counting(ring_mod, n, calls) for n in
        ("attention_out_lse_reference", "attention_bwd_lse_reference")]
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        with activate_rules(ShardingRules(mesh)):
            for impl in ("ring", "chunked"):
                c = cfg.replace(attn_impl=impl)
                calls.clear()
                K.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, _, grads = build_loss_and_grads(c)(fresh(), batch)
                torch.cuda.synchronize()
                grad_s = time.perf_counter() - t0
                counts = {k: v for k, v in K.launch_counts().items() if v}
                routes = K.launch_counts_by_route()
                ring_calls = calls.get("ring_attention_sharded", 0)
                params = fresh()
                step = build_train_step(c, opt)
                t0 = time.perf_counter()
                params, _, metrics = step(params, adamw.init(opt, params),
                                          batch)
                torch.cuda.synchronize()
                runs[impl] = dict(
                    loss=loss, grads=grads, metrics=metrics,
                    params=[p.detach() for p in adamw.tree_leaves(params)],
                    counts=counts, routes=routes, ring_calls=ring_calls,
                    plain=sum(v for k, v in calls.items()
                              if k != "ring_attention_sharded"),
                    grad_s=grad_s, step_s=time.perf_counter() - t0)
    finally:
        torch.use_deterministic_algorithms(False)
        for u in undo:
            u()
        undo_plain()
    ring, chunked = runs["ring"], runs["chunked"]
    diff = [i for i, (a, b) in enumerate(zip(ring["grads"],
                                             chunked["grads"]))
            if not torch.equal(a, b)]
    pdiff = [i for i, (a, b) in enumerate(zip(ring["params"],
                                              chunked["params"]))
             if not torch.equal(a, b)]
    same_loss = torch.equal(ring["loss"], chunked["loss"]) and all(
        torch.equal(ring["metrics"][k], chunked["metrics"][k])
        for k in ring["metrics"])
    rec = {"config": "starcoder2-7b", "layers": SC_DEPTH,
           "params": count_params(cfg), "batch": SC_B, "seq": SC_S,
           "loss": {k: r["loss"].item() for k, r in runs.items()},
           "loss_and_grads_s": {k: r["grad_s"] for k, r in runs.items()},
           "step_s": {k: r["step_s"] for k, r in runs.items()},
           "launches": {k: r["counts"] for k, r in runs.items()},
           "ring_attention_sharded_calls": ring["ring_calls"],
           "bitwise": {"loss_and_metrics": same_loss,
                       "grads_differing": diff, "params_differing": pdiff},
           "leaves": len(ring["grads"])}
    log(f"[distributed] starcoder2-7b width, {SC_DEPTH} layers "
        f"({rec['params'] / 1e9:.3f} B params), bf16 over f32 masters, "
        f"remat full, B {SC_B} x S {SC_S}, (1, 1) mesh: loss ring "
        f"{rec['loss']['ring']:.6f} chunked {rec['loss']['chunked']:.6f}, "
        f"loss and metrics equal {same_loss}; gradients differing "
        f"{diff} and updated parameters differing {pdiff} of "
        f"{rec['leaves']}; ring_attention_sharded calls {ring['ring_calls']}"
        f" (want {2 * SC_DEPTH}) and {chunked['ring_calls']} in the chunked "
        f"step; launches {rec['launches']} (want {want} each); loss and "
        f"grads s {rec['loss_and_grads_s']} (the ring's first: it includes "
        f"the process's first step at these shapes), step s "
        f"{rec['step_s']}; on {smi}")
    for impl, r in runs.items():
        if r["counts"] != want or any(r["routes"][k] != v
                                      for k, v in want_routes.items()):
            raise AssertionError(f"distributed {impl} step: launches "
                                 f"{r['counts']} {r['routes']}, want {want}")
        if r["plain"]:
            raise AssertionError(f"distributed {impl}: a ring plain version "
                                 f"ran on the card")
    if ring["ring_calls"] != 2 * SC_DEPTH or chunked["ring_calls"]:
        raise AssertionError(f"distributed: ring_attention_sharded calls "
                             f"{ring['ring_calls']} / {chunked['ring_calls']}")
    if sum(plain_calls.values()):
        raise AssertionError(f"distributed: a plain version ran on the card:"
                             f" {plain_calls}")
    if not (same_loss and not diff and not pdiff):
        raise AssertionError(f"distributed: the ring step is not the chunked "
                             f"step bit for bit: {rec['bitwise']}")
    return rec, ring["grads"], base


def _compressed_psum_check(mesh, grads, base):
    """``compressed_psum`` of the ring step's gradients over the one-rank
    NCCL "data" group: equal to ``ef_step``'s output and residual, bit for
    bit (an all-reduce over one rank, a divide by 1)."""
    import torch
    from repro_torch.train import adamw
    from repro_torch.train.grad_compress import (compressed_psum, ef_step,
                                                 init_compressor)
    it = iter(grads)
    tree = adamw.tree_map(lambda _: next(it), base)
    state = init_compressor(tree)
    want, wstate = ef_step(tree, state)
    got, gstate = compressed_psum(tree, mesh.get_group("data"), state)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(
        adamw.tree_leaves(got) + adamw.tree_leaves(gstate.residual),
        adamw.tree_leaves(want) + adamw.tree_leaves(wstate.residual)))
    log(f"[distributed] compressed_psum over the one-rank NCCL group equals "
        f"ef_step over {len(grads)} gradient leaves: {same}")
    if not same:
        raise AssertionError("distributed: compressed_psum != ef_step")
    return same


def phase_distributed(smi: str):
    """(a) ``ring_attention_single_device`` at R 4 in bf16 at starcoder2-7b's
    attention width (H 36, KV 4, hd 128, B 1), causal and full: at S 32768
    (8192 a shard) held to one whole-sequence flash forward and backward,
    at S 2048 to the plain versions, the launches exactly 10 forward and
    10 backward (causal) or 16 and 16 (full), all on sm90, and at S 32768
    timed beside the whole-sequence kernels; (b) a one-process NCCL group,
    a (1, 1) ("data", "model") mesh under ``activate_rules``, and the
    starcoder2-7b ring and chunked train steps equal bit for bit
    (``_sc_train_step``); (c) ``compressed_psum`` over that group equal to
    ``ef_step``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rec = {"shards": RING_SHARDS, "heads": RING_H, "kv_heads": RING_KV,
           "head_dim": RING_HD, "rings": {}}
    for causal in (True, False):
        tag = "causal" if causal else "full"
        errs, counts, inp = _ring_case(gen, RING_S, causal, _flash_whole)
        timing = _ring_timing(inp, causal)
        del inp
        plain_errs, _, _ = _ring_case(gen, RING_S_PLAIN, causal,
                                      _plain_whole)
        rec["rings"][tag] = {"s": RING_S, "max_rel_err_vs_flash": errs,
                             f"s{RING_S_PLAIN}_max_rel_err_vs_plain":
                                 plain_errs,
                             "launches": counts, **timing}
        log(f"[distributed] ring R {RING_SHARDS} S {RING_S} {tag}: forward "
            f"{timing['ring_fwd_ms']:.2f} ms, forward + backward "
            f"{timing['ring_fwd_bwd_ms']:.2f} ms; one whole-sequence flash "
            f"forward {timing['flash_fwd_ms']:.2f} ms, backward "
            f"{timing['flash_bwd_ms']:.2f} ms; bound forward "
            f"{timing['fwd_bound_ms']:.2f} ms, forward + backward "
            f"{timing['fwd_bwd_bound_ms']:.2f} ms; on {smi}")
        torch.cuda.empty_cache()
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    try:
        rec["starcoder2_step"], grads, base = _sc_train_step(mesh, smi)
        rec["compressed_psum_equals_ef_step"] = _compressed_psum_check(
            mesh, grads, base)
        del grads, base
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port is not beside this script "
              f"({SRC / 'repro_torch'} missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    kern = timed("kernels", phase_kernels)
    kern.update(timed("dense kernels", phase_dense_kernels))
    bwd = timed("backward kernels", phase_backward_kernels)
    timed("parity", phase_parity)
    timed("zamba parity", phase_zamba_parity)
    timed("moe and dense parity", phase_moe_dense_parity)
    launches, routes = timed("serve", phase_serve, smi)
    zamba, zamba_routes = timed("zamba serve", phase_zamba_serve, smi)
    routes.update(zamba_routes)
    transformers, transformer_runs = {}, {}
    for label, phase in (("olmoe-1b-7b", phase_moe_serve),
                         ("mistral-nemo-12b", phase_dense_serve),
                         ("arctic-480b", phase_arctic_serve)):
        runs, transformers[label] = timed(f"{label} serve", phase, smi)
        transformer_runs.update(runs)
    moves = timed("residency", phase_residency, smi)
    gateway_launches, gateway = timed("gateway", phase_gateway, smi)
    timed("train parity", phase_train_parity)
    train = timed("train", phase_train, smi)
    launch = timed("launch", phase_launch, smi, train)
    shd = timed("sharding", phase_sharding, smi)
    ep = timed("expert parallel", phase_expert_parallel, smi)
    ssm = timed("ssm sharding", phase_ssm_sharding, smi)
    ssv = timed("serve sharding", phase_serve_sharding, smi)
    job = timed("job", phase_job, smi, train)
    zt = timed("zamba train", phase_zamba_train, smi)
    xl = timed("xlstm", phase_xlstm, smi)
    fr = timed("frontends", phase_frontends, smi)
    ft = timed("frontend train", phase_frontend_train, smi)
    ex = timed("examples", phase_examples, smi)
    dr = timed("distributed", phase_distributed, smi)
    frontend_launches = {
        "hubert-xlarge encode": fr["hubert-xlarge"]["launches"],
        "paligemma-3b patch prefill + decode":
            fr["paligemma-3b"]["patch_prefill"]["launches"],
        "paligemma-3b static": fr["paligemma-3b"]["static"]["launches"],
        "paligemma-3b continuous":
            fr["paligemma-3b"]["continuous"]["launches"]}
    record = []
    for name, per_kind in kern.items():
        main_kind = "bf16"
        other = "int8" if name in PAGED else "f32"
        rec = per_kind[main_kind]
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name] if name in PAGED else zamba[name],
            "max_abs_err": max(r["max_abs_err"] for r in per_kind.values()),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        }
        if name in PAGED:
            entry["enqueue_ms"] = {"sm90": rec["enqueue_ms"],
                                   "cuda_core": per_kind["f32"]["enqueue_ms"]}
            entry["int8"] = {k: per_kind[other][k] for k in
                             ("ms", "plain_ms", "bound_ms", "library_ms",
                              "enqueue_ms")}
        if name == "rmsnorm_fused":
            entry["launches_yi6b"] = launches[name]
            entry["rows"] = rec["rows"]
            entry["launches_xlstm_serve"] = \
                xl["serve"]["launches"]["rmsnorm_fused"]
            entry["launches_xlstm_train"] = xl["train"]["launches"][name]
            entry["xlstm_shapes_max_abs_err"] = xl["norm_kernels"][name]
        if name in routes:
            entry["launches_by_route"] = routes[name]
        if "transformers" in rec:
            entry["transformer_shapes"] = rec["transformers"]
        entry["launches_gateway"] = gateway_launches[name]
        entry["launches_frontends"] = {
            run: counts[name] for run, counts in frontend_launches.items()}
        entry["launches_transformers"] = {
            run: counts[name] for run, counts in transformer_runs.items()}
        if name in train["launches_per_step"]:
            entry["launches_train"] = train["launches"][name]
            entry["launches_job"] = job["launches"][name]
            entry["launches_sharding"] = _sharding_launches(shd, name)
            entry["launches_expert_parallel"] = _ep_launches(ep, name)
        if name in zt["train"]["launches_per_step"]:
            entry["launches_zamba_train"] = zt["train"]["launches"][name]
        if name in ft["hubert-xlarge"]["launches_per_step"]:
            entry["launches_frontend_train"] = _frontend_train_launches(
                ft, name)
        entry["launches_distributed"] = _distributed_launches(dr, name)
        if name in ssm["local_kernels"]:
            entry["launches_ssm_sharding"] = _ssm_launches(ssm, name)
            entry["zamba_local_max_err"] = ssm["local_kernels"][name]
        if name in ssv["local_kernels"]:
            entry["launches_serve_sharding"] = _serve_sharding_launches(
                ssv, name)
            entry["serve_local_max_err"] = ssv["local_kernels"][name]
        record.append(entry)
    for name, fwd in (("rmsnorm_bwd", "rmsnorm_fused"),
                      ("flash_attention_bwd", "flash_attention_fwd")):
        rec = bwd[name]["bf16"]
        record.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[fwd],
            "kind": "backward: the port's own kernel, no TPU counterpart "
                    "(the reference differentiates its jnp version with "
                    "XLA); 'replaces' names the forward's TPU kernel",
            "launches": train["launches"][name],
            "launches_per_step": train["launches_per_step"][name],
            "launches_job": job["launches"][name],
            "launches_sharding": _sharding_launches(shd, name),
            "launches_expert_parallel": _ep_launches(ep, name),
            "launches_by_route": train["launches_by_route"][name],
            "max_abs_err": max(r["max_abs_err"] for r in bwd[name].values()),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"],
            "split_ms": rec["split_ms"]})
        record[-1]["launches_zamba_train"] = zt["train"]["launches"][name]
        record[-1]["zamba_shapes_max_rel_err"] = zt["bwd_shapes"][name]
        record[-1]["launches_frontend_train"] = _frontend_train_launches(
            ft, name)
        record[-1]["launches_distributed"] = _distributed_launches(dr, name)
        record[-1]["launches_ssm_sharding"] = _ssm_launches(ssm, name)
        record[-1]["zamba_local_max_rel_err"] = ssm["local_kernels"][name]
        # the forward's and the backward's errors at phase 8c (b)'s shapes
        record[-1]["sharded_local"] = rec["sharded_local"]
        record[-1]["arctic_local"] = rec["arctic_local"]
        if "frontend_shapes" in rec:
            record[-1]["frontend_shapes"] = {
                kind: bwd[name][kind]["frontend_shapes"]
                for kind in bwd[name] if "frontend_shapes" in bwd[name][kind]}
        if name == "rmsnorm_bwd":
            record[-1]["launches_xlstm_train"] = \
                xl["train"]["launches"][name]
            record[-1]["xlstm_shapes_max_rel_err"] = \
                xl["norm_kernels"][name]
    ssd = zt["ssd_scan_bwd"]
    record.append({
        "name": "ssd_scan_bwd", "route": "cuda", "source":
        SOURCES["ssd_scan_bwd"], "replaces": REPLACES["ssd_scan"],
        "kind": "backward: the port's own kernel, no TPU counterpart (the "
                "reference differentiates its jnp scan with XLA); 'replaces' "
                "names the forward's TPU kernel; bf16 on wgmma + TMA (sm90), "
                "f32 on CUDA cores (ssd_scan_bwd.cu)",
        "launches": zt["train"]["launches"]["ssd_scan_bwd"],
        "launches_per_step": zt["train"]["launches_per_step"]["ssd_scan_bwd"],
        "launches_by_route": zt["train"]["launches_by_route"]["ssd_scan_bwd"],
        "max_abs_err": max(ssd["max_abs_err"].values()),
        "ms": ssd["bf16"]["ms"], "plain_ms": ssd["bf16"]["plain_ms"],
        "bound_ms": ssd["bf16"]["bound_ms"],
        "bound_by": ssd["bf16"]["bound_by"], "library_ms": None,
        "shape": ssd["bf16"]["shape"], "split_ms": ssd["bf16"]["split_ms"],
        "f32": {k: ssd["f32"][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by")},
        "launches_distributed": _distributed_launches(dr, "ssd_scan_bwd"),
        "launches_ssm_sharding": _ssm_launches(ssm, "ssd_scan_bwd"),
        "zamba_local_max_rel_err": ssm["local_kernels"]["ssd_scan_bwd"]})
    log(f"[done] every phase passed in {time.perf_counter() - t0:.1f} s on "
        f"{smi}; seconds a phase: {seconds}")
    print(json.dumps({"kernels": record, "transformers": transformers,
                      "residency": moves, "gateway": gateway,
                      "train": train, "launch": launch,
                      "sharding": shd, "expert_parallel": ep,
                      "ssm_sharding": ssm, "serve_sharding": ssv,
                      "job": job,
                      "zamba_train": zt,
                      "xlstm": xl, "frontends": fr,
                      "frontend_train": ft, "examples": ex,
                      "distributed": dr}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
