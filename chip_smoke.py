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
   one; a bf16 hd 192 call must raise); RMSNorm at 8192 x 2048, D 5120,
   7168 and a ragged 1002 (each on the kernel its D picks); the training
   shapes timed beside the plain version, the library's backward (SDPA,
   ``F.rms_norm``) and the bound, with each launch's device time;
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
6. residency: full-width yi-6b again, bf16 and int8 pools, plain and
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
7. gateway: ``KottaServeGateway`` over full-width yi-6b engines (one
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
   internlm2-1.8b and olmoe-1b-7b widths (depth 2, B 2, S 256: the loss
   within 1e-5 and every gradient within 1e-4 of its leaf's max); then
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
   seconds and GB/s.

The second-to-last line of output is a JSON ``kernels`` record (with the
launches on the transformer runs, the residency phase's move times, the
gateway phase's results and the train phase's numbers); the last is
``{"ok": true, "device": {...}}``. Without CUDA, or without the port beside
this script, it prints no result and exits nonzero. It takes no arguments:
every run drives all eight phases.
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
# dQ kernels at hd 128 (internlm2-1.8b training). None may spill.
ON_PATH_SM90 = {
    "flash_sm90_kernelILi64E": "flash bf16 hd 64",
    "flash_sm90_kernelILi128E": "flash bf16 hd 128",
    "ssd_sm90_kernel": "ssd bf16 N = P = 64",
    "paged_attn_sm90_kernelILi128ELb0ELb0E": "paged hd 128 bf16 pool",
    "paged_attn_sm90_kernelILi128ELb1ELb0E": "paged hd 128 int8 pool",
    "paged_attn_sm90_kernelILi128ELb0ELb1E": "paged split hd 128 bf16 pool",
    "paged_attn_sm90_kernelILi128ELb1ELb1E": "paged split hd 128 int8 pool",
    "flash_bwd_dkdv_sm90_kernelILi128E": "flash bwd dK/dV bf16 hd 128",
    "flash_bwd_dq_sm90_kernelILi128E": "flash bwd dQ bf16 hd 128"}


# The other backward kernels the training path and its f32 parity launch:
# the bf16 flash backward's delta pass, the f32 CUDA-core flash backward at
# hd 128, RMSNorm's register kernel (D up to 8192 bf16 / 4096 f32) and
# shared-memory kernel (beyond) in both dtypes.
BACKWARD_KERNELS = {
    "flash_bwd_delta_sm90_kernelILi128E": "flash bwd delta bf16 hd 128",
    "flash_bwd_delta_kernel": "flash bwd delta f32",
    "flash_bwd_dkdv_kernelILi128E": "flash bwd dK/dV f32 hd 128",
    "flash_bwd_dq_kernelILi128E": "flash bwd dQ f32 hd 128",
    "rmsnorm_bwd_reg_kernelI13__nv_bfloat16Lb1E": "rmsnorm bwd registers bf16",
    "rmsnorm_bwd_reg_kernelIfLb1E": "rmsnorm bwd registers f32",
    "rmsnorm_bwd_kernelI13__nv_bfloat16": "rmsnorm bwd smem bf16",
    "rmsnorm_bwd_kernelIf": "rmsnorm bwd smem f32"}


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

def _pool(gen, kind, num_pages, dev, nkv=KV, ps=PS):
    """A random pool of ``kind``: bf16, int8 with row scales, or f32."""
    import torch
    from repro_torch.kernels import quantize_pool
    shape = (nkv, num_pages, ps, HD)
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
    pages = ((last_pos.clamp_min(0) // PS) + 1).clamp(max=NPAGES)
    n_pages = int(pages.sum())
    row = HD * pool["k"].element_size() + (4 if "k_scale" in pool else 0)
    kv_bytes = 2 * n_pages * KV * PS * row
    return (kv_bytes + q.numel() * q.element_size()
            + pt.numel() * 4 + out.numel() * out.element_size()
            + last_pos.numel() * 4)


def _flops_needed(q_pos):
    """QK^T and PV multiply-adds over the keys each query row sees."""
    visible = (q_pos.clamp_min(-1) + 1).sum().item()    # over (B, C)
    return 4.0 * visible * H * HD


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


def _olmoe_paged_cases(gen, kind, dev):
    """The paged kernels at olmoe-1b-7b's serve shapes on the tensor-core
    route: B 8, H 16 over KV 16 (G 1), hd 128, page size 16, 32 pages a
    row; decode at the split count the ops layer picks, prefill C 32 at
    q_start 0 and past it, verify T 5. Returns {name: [(kernel, plain)]}."""
    import torch
    from repro_torch.kernels import (default_num_splits, flash_decode_fwd,
                                     flash_prefill_fwd, flash_verify_fwd,
                                     paged_decode_reference,
                                     paged_prefill_reference,
                                     paged_verify_reference)
    h = nkv = 16
    num_pages = B * NPAGES + 1
    pool = _pool(gen, kind, num_pages, dev, nkv=nkv)
    scales = dict(k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"))
    pt = _page_table(gen, num_pages, dev)
    span = NPAGES * PS
    splits = default_num_splits(NPAGES, batch=B, split_budget=32)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    def ri(lo, hi):
        return torch.randint(lo, hi, (B,), generator=gen, device=dev,
                             dtype=torch.int32)

    q1, qv, qp = rn(B, h, HD), rn(B, T_VERIFY, h, HD), rn(B, C_PREFILL, h, HD)
    lengths, pos, q_start = (ri(1, span + 1), ri(0, span - T_VERIFY + 1),
                             ri(1, span - C_PREFILL + 1))
    args = (pool["k"], pool["v"], pt)
    return {
        "flash_decode_fwd": [(
            lambda: flash_decode_fwd(q1, *args, lengths, num_splits=splits,
                                     **scales),
            lambda: paged_decode_reference(q1, *args, lengths, **scales))],
        "flash_verify_fwd": [(
            lambda: flash_verify_fwd(qv, *args, pos, num_splits=splits,
                                     **scales),
            lambda: paged_verify_reference(qv, *args, pos, **scales))],
        "flash_prefill_fwd": [(
            lambda qs=qs: flash_prefill_fwd(qp, *args, qs, **scales),
            lambda qs=qs: paged_prefill_reference(qp, *args, qs, **scales))
            for qs in (torch.zeros_like(q_start), q_start)],
    }


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
                bytes_s = _bytes_needed(pool, pt, q_pos[:, -1], q, got) \
                    / HBM_BYTES_PER_S
                ops_s = _flops_needed(q_pos) / BF16_FLOPS_PER_S
                rec["bound_ms"] = max(bytes_s, ops_s) * 1e3
                rec["bound_by"] = "bytes" if bytes_s >= ops_s else "operations"
                rec["ms"] = time_ms(kern)
                rec["plain_ms"] = time_ms(plain, iters=5)
                rec["library_ms"] = time_ms(_sdpa_case(q, pool, pt, q_pos))
                log(f"[kernels] {name} {kind}: kernel {rec['ms']:.4f} ms, "
                    f"plain {rec['plain_ms']:.4f} ms, sdpa "
                    f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f}"
                    f" ms ({rec['bound_by']})")
    for kind in ("bf16", "int8"):
        for name, variants in _olmoe_paged_cases(gen, kind, dev).items():
            rec = results[name][kind]
            for vi, (kern, plain) in enumerate(variants):
                err = _max_err(kern(), plain())
                ok = math.isfinite(err) and err <= TOL_BF16
                log(f"[kernels] {name} {kind} olmoe-1b-7b shape case{vi}: "
                    f"max|kernel-plain| {err:.3e} (tol {TOL_BF16}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} {kind} disagrees at the "
                                         f"olmoe shape: {err}")
                rec["max_abs_err"] = max(err, rec["max_abs_err"])
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


def _ssd_case(gen, dev, dtype, b, s, chunk, dt_scale=1.0):
    """An SSD scan at the Zamba2 widths (H 64, N = P = 64) and its plain
    version on the same inputs; x / dt_scale keeps the outputs of order 1
    under a strong decay."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    args = ((rn(b, s, Z_SSM_H, Z_P) / dt_scale).to(dtype),
            F.softplus(rn(b, s, Z_SSM_H)) * dt_scale, 0.5 * rn(Z_SSM_H),
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
    causal SDPA and the bound: B 8, S 256 at G 1, 4 and 7 (hd 128), and
    mistral-nemo-12b's dense-admission bucket of 2 prompts padded to 96."""
    import torch
    from repro_torch import kernels as K
    out = {}
    shapes = [(label, ZB, ZS, h, nkv) for label, h, nkv in FLASH_TRANSFORMERS]
    shapes.append(("mistral-nemo-12b bucket", 2, 96, 32, 8))
    for label, b, s, h, nkv in shapes:
        q = torch.randn(b, s, h, 128, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(b, s, nkv, 128, generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        err = _max_err(K.flash_attention_fwd(q, k, v),
                       K.attention_reference(q, k, v))
        if not (math.isfinite(err) and err <= TOL_BF16):
            raise AssertionError(f"flash {label} disagrees: {err}")
        pairs = b * h * s * (s + 1) // 2
        bound_s = max((2 * b * s * h + 2 * b * s * nkv) * 128 * 2
                      / HBM_BYTES_PER_S, 4.0 * 128 * pairs / BF16_FLOPS_PER_S)
        rec = {"shape": [b, s, h, nkv, 128], "max_abs_err": err,
               "bound_ms": bound_s * 1e3,
               "ms": time_ms(lambda: K.flash_attention_fwd(q, k, v)),
               "library_ms": time_ms(_sdpa_dense(q, k, v))}
        out[label] = rec
        log(f"[kernels] flash_attention_fwd bf16 {label} (B {b}, S {s}, H "
            f"{h}, KV {nkv}, hd 128): max|kernel-plain| {err:.3e}, kernel "
            f"{rec['ms']:.4f} ms, sdpa {rec['library_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms")
    return out


def _rmsnorm_transformer_widths(gen, dev):
    """bf16 RMSNorm at the new widths (mistral-nemo-12b's 5120, Arctic's
    7168) over the static prefill's 2048 rows and decode's 8, held against
    the plain version and timed beside ``F.rms_norm`` and the byte
    bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K
    out = {}
    for rows, d in ((ZB * ZS, 5120), (ZB * ZS, 7168), (8, 5120), (8, 7168)):
        x = torch.randn(rows, d, generator=gen, device=dev).bfloat16()
        w = 0.25 + 0.05 * torch.randn(d, generator=gen, device=dev)
        wb = w.bfloat16()
        err = _max_err(K.rmsnorm_fused(x, w), K.rmsnorm_reference(x, w))
        if not (math.isfinite(err) and err <= TOL_BF16):
            raise AssertionError(f"rmsnorm {rows}x{d} disagrees: {err}")
        rec = {"max_abs_err": err,
               "bound_ms": (2 * rows * d * 2 + 4 * d) / HBM_BYTES_PER_S * 1e3,
               "ms": time_ms(lambda: K.rmsnorm_fused(x, w)),
               "library_ms": time_ms(lambda: F.rms_norm(x, (d,), wb, 1e-6))}
        out[f"{rows}x{d}"] = rec
        log(f"[kernels] rmsnorm_fused bf16 {rows}x{d}: max|kernel-plain| "
            f"{err:.3e}, kernel {rec['ms']:.4f} ms, F.rms_norm "
            f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms")
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


def _static_parity(cfg, seqs, label):
    """The static engine's steps, f32, batch 2: a prefill of each length in
    ``seqs`` and four decode steps over the cache grown by 8 rows, on the
    card against the CPU; logits and every cache leaf within TOL_PARITY,
    every flash launch on the CUDA-core route."""
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
    if counts["rmsnorm_fused"] < 1 or counts["flash_attention_fwd"] < 1:
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
    """The residency surface on full-width yi-6b (32 layers, bf16 weights
    from seed 0), the serve phase's 8 prompts, 32 new tokens, 8 slots,
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
    cfg = get_config("yi-6b")
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
    full-width yi-6b engines (32 layers, bf16 weights from seed 0, one tree
    for every replica; 8 slots, max_len 512, decode chunks of
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
    cfg = get_config("yi-6b")
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
TRAIN_STEPS, TRAIN_EVERY, TRAIN_REVOKE = 6, 3, 4
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


def _rms_bwd_case(gen, dev, dtype, rows, d):
    from repro_torch import kernels as K
    x = torch_randn(gen, dev, rows, d).to(dtype)
    g = torch_randn(gen, dev, rows, d).to(dtype)
    w = 1.0 + 0.1 * torch_randn(gen, dev, d)
    return (lambda: K.rmsnorm_bwd(x, w, g),
            lambda: K.rmsnorm_bwd_reference(x, w, g), (x, w, g))


def _sdpa_bwd(q, k, v, dout):
    """Library yardstick: the backward of causal SDPA (flash backend where
    it takes the call) on (B,H,S,hd) copies, graph built outside the timed
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
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True, **kw)
    gg = dout.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qq, kk, vv), gg,
                                       retain_graph=True)


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


def _device_split(fn, calls: int = 10) -> dict:
    """{kernel name: device ms a call} of ``fn`` under ``torch.profiler``
    (the kernels' self device time over ``calls`` calls): where a wrapper's
    launches spend its time."""
    import re
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"(\w+_kernel)", e.key)
        name = m.group(1) if m else e.key[:60]
        split[name] = split.get(name, 0.0) + e.self_device_time_total / 1e3 / calls
    return split


def phase_backward_kernels():
    """The port's backward kernels against autograd of their plain
    versions on the same inputs, in bf16 (within TOL_BF16 of each
    gradient's max |value|) and f32 (TOL_F32): flash attention at
    internlm2-1.8b's training shape (B 8, S 1024, H 16, KV 8, hd 128,
    causal) and at hd 64, G 1 and 7, a ragged S of 1000 and non-causal,
    each bf16 case on the tensor-core route and each f32 one on the
    CUDA-core route, and a bf16 hd 192 call, which must raise; RMSNorm at
    8192 x 2048 and at D 5120, 7168 and a ragged 1002 (scalar loads), each
    on the kernel of its D. Each twice, bit for bit the same (no atomics).
    The training shapes in bf16 timed beside the plain version, the
    library's backward and the bound, with each launch's device time
    (``torch.profiler``)."""
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
    rms_shapes = [("train", (TB * TS, TD)), ("D 5120", (512, 5120)),
                  ("D 7168", (512, 7168)), ("ragged D 1002", (64, 1002))]
    results = {"flash_attention_bwd": {}, "rmsnorm_bwd": {}}
    for dtype, tol, kind in ((torch.bfloat16, TOL_BF16, "bf16"),
                             (torch.float32, TOL_F32, "f32")):
        cases = ([("flash_attention_bwd", label,
                   _flash_bwd_case(gen, dev, dtype, *shape), shape)
                  for label, shape in flash_shapes]
                 + [("rmsnorm_bwd", label, _rms_bwd_case(gen, dev, dtype,
                                                         *shape), shape)
                    for label, shape in rms_shapes])
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
            if kind != "bf16" or label != "train":
                continue
            if name == "flash_attention_bwd":
                nbytes, flops = _flash_bwd_bound(*shape[:5], 2)
                lib = _sdpa_bwd(*inputs)
            else:
                nbytes, flops = _rms_bwd_bound(*shape, 2)
                lib = _rms_bwd_lib(*inputs)
            bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
            rec.update(bound_ms=max(bytes_s, ops_s) * 1e3,
                       bound_by="bytes" if bytes_s >= ops_s else "operations",
                       ms=time_ms(kern, iters=10),
                       plain_ms=time_ms(plain, iters=3, warmup=1),
                       library_ms=time_ms(lib, iters=10), shape=list(shape))
            rec["split_ms"] = _device_split(kern)
            log(f"[kernels] {name} bf16 {shape}: kernel {rec['ms']:.4f} ms, "
                f"plain {rec['plain_ms']:.4f} ms, library "
                f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}); device ms a call by launch (profiler) "
                f"{ {k: round(v, 4) for k, v in rec['split_ms'].items()} }")
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


def _train_grads(fam, cfg, params, batch):
    import torch
    from repro_torch.train import adamw
    leaves = adamw.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = fam.train_loss(cfg, params, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _train_parity(cfg, label):
    """``train_loss`` and every gradient at ``cfg`` (f32, depth 2, B 2, S
    256) on the card (kernels, backward kernels) against the CPU (plain
    versions, autograd) from the same weights."""
    import numpy as np
    import torch
    from repro_torch.kernels import (launch_counts, launch_counts_by_route,
                                     reset_launch_counts)
    from repro_torch.models import get_family, init_params
    fam = get_family(cfg)
    gpu = init_params(cfg, fam.layout(cfg), seed=0, device="cuda",
                      dtype=torch.float32)
    cpu = _to(gpu, "cpu")
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, ZS)).astype(np.int64)
             for k in ("tokens", "labels")}
    reset_launch_counts()
    gl, gg = _train_grads(fam, cfg, gpu, {k: torch.from_numpy(v).cuda()
                                          for k, v in batch.items()})
    torch.cuda.synchronize()
    counts, routes = launch_counts(), launch_counts_by_route()
    cl, cg = _train_grads(fam, cfg, cpu, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    loss_err = abs(gl.item() - cl.item())
    grad_err = max(_rel_err(a.cpu(), b) for a, b in zip(gg, cg))
    log(f"[train parity] {label} widths, {cfg.num_layers} layers, f32, B 2, "
        f"S {ZS}: loss card {gl.item():.6f} cpu {cl.item():.6f} "
        f"(|diff| {loss_err:.2e}, tol 1e-5), max gradient error / leaf max "
        f"{grad_err:.2e} (tol 1e-4) over {len(cg)} leaves, launches "
        f"{counts}")
    if not (loss_err <= 1e-5 and grad_err <= 1e-4):
        raise AssertionError(f"train parity {label}: loss {loss_err}, "
                             f"grads {grad_err}")
    for name in ("flash_attention_fwd", "flash_attention_bwd", "rmsnorm_fused",
                 "rmsnorm_bwd"):
        if counts[name] < cfg.num_layers:
            raise AssertionError(f"train parity {label} missed {name}: "
                                 f"{counts}")
    if routes["flash_attention_fwd"]["sm90"] \
            or routes["flash_attention_bwd"]["sm90"]:
        raise AssertionError(f"f32 flash left the CUDA-core route: {routes}")
    del gpu, cpu, gg, cg
    torch.cuda.empty_cache()


def phase_train_parity():
    """internlm2-1.8b widths and olmoe-1b-7b widths (the MoE aux losses) at
    depth 2 in f32, card against CPU."""
    from repro_torch.configs import get_config
    for name in ("internlm2-1.8b", "olmoe-1b-7b"):
        _train_parity(get_config(name).replace(num_layers=2, dtype="float32"),
                      name)


class _StepProbe:
    """Wraps the trainer's step: per step, the wall time (synchronized) and
    the kernels' launch counts, reset just before it and read just after."""

    def __init__(self, fn):
        self.fn = fn
        self.steps = []

    def __call__(self, params, opt_state, batch):
        import torch
        from repro_torch import kernels as K
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = self.fn(params, opt_state, batch)
        torch.cuda.synchronize()
        self.steps.append((time.perf_counter() - t0, K.launch_counts(),
                           K.launch_counts_by_route()))
        return out


def _timed_checkpointer(store, run):
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

    ck = Timed(store, run)
    ck.events = []
    return ck


def _tree_bytes(tree) -> int:
    from repro_torch.checkpoint.checkpointer import _flatten
    return sum(t.numel() * t.element_size() for _, t in _flatten(tree))


def _plain_call_counter():
    """Count calls of the plain versions behind the ops entries, so a run
    can show that no backward on the card went through one."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rmsnorm import ops as rops
    calls = {"attention_reference": 0, "rmsnorm_reference": 0}

    def wrap(mod, name):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        setattr(mod, name, counted)
        return lambda: setattr(mod, name, fn)

    undo = [wrap(fops, "attention_reference"), wrap(rops, "rmsnorm_reference")]
    return calls, lambda: [u() for u in undo]


def _train_run(cfg, opt, revoke: bool):
    """One ElasticTrainer run of TRAIN_STEPS steps on a fresh store; returns
    (trainer, report, probe, checkpoint events)."""
    from repro_torch.core import ObjectStore, VirtualClock
    from repro_torch.data import SyntheticCorpus, TokenLoader
    from repro_torch.train import ElasticTrainer
    store = ObjectStore(clock=VirtualClock())
    keys = SyntheticCorpus.build(store, "train", num_shards=2,
                                 tokens_per_shard=65_536,
                                 vocab_size=cfg.vocab_size, seed=0)
    loader = TokenLoader(store.get, keys, batch_size=TB, seq_len=TS, seed=0)
    ck = _timed_checkpointer(store, "revoked" if revoke else "plain")
    trainer = ElasticTrainer(cfg, opt, ck, seed=0, device="cuda")
    probe = _StepProbe(trainer._step_fn)
    trainer._step_fn = probe
    fired = []

    def revoke_at(step):
        if revoke and step == TRAIN_REVOKE and not fired:
            fired.append(step)
            return True
        return False

    rep = trainer.train(loader, TRAIN_STEPS, checkpoint_every=TRAIN_EVERY,
                        revoke_at=revoke_at)
    return trainer, rep, probe, ck.events


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
    from repro_torch.train import AdamWConfig
    from repro_torch.train.adamw import tree_leaves
    cfg = get_config("internlm2-1.8b")
    assert cfg.remat == "full" and cfg.param_dtype == "float32"
    opt = AdamWConfig(learning_rate=TRAIN_LR, warmup_steps=2,
                      decay_steps=100, state_dtype="int8")
    L = cfg.num_layers
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd": L,
            "rmsnorm_fused": 4 * L + 1, "rmsnorm_bwd": 2 * L + 1}
    want_routes = {
        "flash_attention_fwd": {"sm90": 2 * L, "cuda_core": 0},
        "flash_attention_bwd": {"sm90": L, "cuda_core": 0},
        "rmsnorm_bwd": {"registers": 2 * L + 1, "smem": 0}}
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
        t0 = time.perf_counter()
        ref, ref_rep, ref_probe, ref_ck = _train_run(cfg, opt, revoke=False)
        peak = torch.cuda.max_memory_allocated()
        ref_wall = time.perf_counter() - t0
        ref_final = [t.detach() for t in _state_leaves(ref.final_state)]
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        rev, rev_rep, rev_probe, rev_ck = _train_run(cfg, opt, revoke=True)
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
    steady = st.median(step_s[1:])
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
        "bitwise_restart": bitwise}
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
        f"({len(ref_final)} tensors); launches a step {want}; on {smi}")
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


def _state_leaves(state):
    from repro_torch.checkpoint.checkpointer import _flatten
    return [t for _, t in _flatten(state)]


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
        if name in routes:
            entry["launches_by_route"] = routes[name]
        if "transformers" in rec:
            entry["transformer_shapes"] = rec["transformers"]
        entry["launches_gateway"] = gateway_launches[name]
        entry["launches_transformers"] = {
            run: counts[name] for run, counts in transformer_runs.items()}
        if name in train["launches_per_step"]:
            entry["launches_train"] = (train["launches_per_step"][name]
                                       * train["steps"])
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
            "launches": train["launches_per_step"][name] * train["steps"],
            "launches_per_step": train["launches_per_step"][name],
            "launches_by_route": {
                route: n * train["steps"] for route, n in
                train["launches_by_route_per_step"][name].items()},
            "max_abs_err": max(r["max_abs_err"] for r in bwd[name].values()),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"],
            "split_ms": rec["split_ms"]})
    log(f"[done] every phase passed in {time.perf_counter() - t0:.1f} s on "
        f"{smi}; seconds a phase: {seconds}")
    print(json.dumps({"kernels": record, "transformers": transformers,
                      "residency": moves, "gateway": gateway,
                      "train": train}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
