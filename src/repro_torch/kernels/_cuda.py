"""Build, load and call the port's hand-written CUDA kernels.

Each source under ``src/repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. The library is built at first use into ``csrc/build/`` (listed in
``.gitignore``) under a name that carries the hash of the source, of every
shared header (``csrc/*.cuh``) and of the flags, so an edited source or
header is rebuilt and an unchanged one is reused. Nothing here
runs at import: the CPU tests import every module, and ``nvcc`` is needed
only when a kernel is first launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("paged_attention.cu", "rmsnorm.cu", "flash_attention.cu",
           "ssd_scan.cu", "paged_attention_sm90.cu", "flash_attention_bwd.cu",
           "flash_attention_bwd_sm90.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C interface (enum DType in every csrc/*.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of each source's extern "C" entry points.
SIGNATURES = {
    "paged_attention.cu": {
        "paged_decode_fwd": [_P, _I, _P, _P, _I, _P, _P, _P, _P] + [_I] * 8
                            + [_P, _P, _P, _P, _P],
        "paged_prefill_fwd": [_P, _I, _P, _P, _I, _P, _P, _P, _P] + [_I] * 8
                             + [_P, _P],
        "paged_verify_fwd": [_P, _I, _P, _P, _I, _P, _P, _P, _P] + [_I] * 9
                            + [_P, _P, _P, _P, _P],
    },
    "rmsnorm.cu": {"rmsnorm_reg_fwd": [_P, _I, _P, _P, _I, _I, _F, _P],
                   "rmsnorm_smem_fwd": [_P, _I, _P, _P, _I, _I, _F, _P],
                   "rmsnorm_bwd_reg": [_P, _I, _P, _P, _P, _P, _I, _P, _I,
                                       _I, _F, _P],
                   "rmsnorm_bwd_smem": [_P, _I, _P, _P, _P, _P, _I, _P, _I,
                                        _I, _F, _P]},
    "flash_attention.cu": {
        "flash_attention_f32_fwd": [_P] * 4 + [_I] * 7 + [_P, _P],
        "flash_attention_sm90_fwd": [_P] * 4 + [_I] * 7 + [_P, _P]},
    "flash_attention_bwd.cu": {
        "flash_attention_f32_bwd": [_P] * 10 + [_I] * 7 + [_P]},
    "flash_attention_bwd_sm90.cu": {
        "flash_attention_bwd_sm90": [_P] * 10 + [_I] * 7 + [_P]},
    "paged_attention_sm90.cu": {
        "paged_attention_sm90_fwd": [_P, _P, _P, _I, _P, _P, _P, _P]
                                    + [_I] * 10 + [_P] * 5},
    "ssd_scan.cu": {
        "ssd_scan_f32_fwd": [_P] * 7 + [_I] * 6 + [_P],
        "ssd_scan_sm90_fwd": [_P] * 7 + [_I] * 7 + [_P]},
}

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(sources=SOURCES) -> dict[str, str]:
    """Compile every stale source, one ``nvcc`` each, all started together.

    Returns {source: compiler log} (``-Xptxas -v``: registers, shared
    memory and spills per kernel); an up-to-date library logs "cached".
    Raises if a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, logs = {}, {}
    for src in sources:
        target = _target(src)
        if target.exists():
            logs[src] = "cached"
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target)
    failed = []
    for src, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[src] = out
        if proc.returncode:
            failed.append(f"{src}:\n{out}")
            continue
        os.replace(tmp, target)            # atomic: readers never see a partial
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def library(source: str = "paged_attention.cu") -> ctypes.CDLL:
    """The loaded library of ``source``, built first if it is stale."""
    lib = _LIBS.get(source)
    if lib is None:
        build((source,))
        lib = ctypes.CDLL(str(_target(source)))
        for name, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[source] = lib
    return lib


# Head dims of the tensor-core (wgmma + TMA) attention kernels.
SM90_HEAD_DIMS = (64, 128, 192, 256)


def attention_route(q_dtype, kv_dtype, hd: int) -> str:
    """The kernel an attention call takes, by dtype: ``"sm90"`` (wgmma +
    TMA: ``flash_attention.cu``'s bf16 kernel, ``paged_attention_sm90.cu``)
    for a bf16 q over bf16 or int8 K/V; ``"cuda_core"`` (the f32 CUDA-core
    kernels) for f32 q or f32 K/V, since wgmma has no full-f32 mode. Raises
    for a bf16 call whose hd the tensor-core kernels do not take; it is
    never rerouted."""
    if q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8):
        if hd not in SM90_HEAD_DIMS:
            raise ValueError(f"bf16 attention runs on the wgmma kernels, "
                             f"whose contract is hd in {SM90_HEAD_DIMS}; "
                             f"got hd={hd}")
        return "sm90"
    return "cuda_core"


# Head dims of the tensor-core (wgmma + TMA) flash-attention backward.
SM90_BWD_HEAD_DIMS = (64, 128)


def attention_bwd_route(dtype, hd: int) -> str:
    """The kernels a flash-attention backward takes, by dtype: ``"sm90"``
    (``flash_attention_bwd_sm90.cu``'s wgmma + TMA dK/dV and dQ kernels)
    for bf16, ``"cuda_core"`` (``flash_attention_bwd.cu``) for f32, since
    wgmma has no full-f32 mode. Raises for a bf16 call whose hd the
    tensor-core kernels do not take; it is never rerouted."""
    if dtype == torch.bfloat16:
        if hd not in SM90_BWD_HEAD_DIMS:
            raise ValueError(f"bf16 flash-attention backward runs on the "
                             f"wgmma kernels, whose contract is hd in "
                             f"{SM90_BWD_HEAD_DIMS}; got hd={hd}")
        return "sm90"
    return "cuda_core"


# State width N and head width P of the tensor-core SSD scan.
SM90_SSD_WIDTH = 64


def ssd_route(dtype, n: int, p: int) -> str:
    """The kernel an SSD scan takes, by dtype: ``"sm90"`` (``ssd_scan.cu``'s
    wgmma + TMA kernel) for bf16, ``"cuda_core"`` (the f32 CUDA-core
    kernel) for f32, since wgmma has no full-f32 mode. Raises for a bf16
    call whose N or P the tensor-core kernel does not take; it is never
    rerouted."""
    if dtype == torch.bfloat16:
        if n != SM90_SSD_WIDTH or p != SM90_SSD_WIDTH:
            raise ValueError(f"bf16 ssd_scan runs on the wgmma kernel, whose "
                             f"contract is N = P = {SM90_SSD_WIDTH}; got "
                             f"N={n}, P={p}")
        return "sm90"
    return "cuda_core"


# Page sizes of the tensor-core paged kernel (a page is one TMA box and
# 64 / page_size pages make a 64-key tile).
SM90_PAGE_SIZES = (8, 16, 32, 64)


def paged_route(name: str, q, k_pages) -> str:
    """``attention_route`` of a paged decode, prefill or verify call, with
    the tensor-core kernel's page-size and group contract: a bf16 call
    outside it raises and is never rerouted."""
    route = attention_route(q.dtype, k_pages.dtype, q.shape[-1])
    g = q.shape[-2] // k_pages.shape[0]
    if route == "sm90" and (k_pages.shape[2] not in SM90_PAGE_SIZES
                            or g > 64):
        raise ValueError(f"{name}: the bf16 wgmma kernel's contract is "
                         f"page_size in {SM90_PAGE_SIZES} and G <= 64; got "
                         f"page_size={k_pages.shape[2]}, G={g}")
    return route


def paged_sm90(name: str, q, k_pages, v_pages, page_table, base, shift: int,
               k_scale, v_scale, num_splits: int):
    """Launch ``paged_attention_sm90.cu`` on q (B,C,H,hd) bf16: query c of
    request b sees the keys at positions <= base[b] + shift + c. With more
    than one split the f32 partials live in one scratch allocation.
    Returns (B,C,H,hd) bf16."""
    b, c, h, hd = q.shape
    nkv, num_pages, ps, _ = k_pages.shape
    out = torch.empty_like(q)
    part = [None] * 3
    if num_splits > 1:
        rows = b * nkv * num_splits * c * (h // nkv)
        ws = torch.empty(rows * (hd + 2), dtype=torch.float32,
                         device=q.device)
        p0 = ws.data_ptr()
        part = [p0, p0 + 4 * rows * hd, p0 + 4 * rows * (hd + 1)]
    rc = library("paged_attention_sm90.cu").paged_attention_sm90_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        DTYPE_CODES[k_pages.dtype], ptr(k_scale), ptr(v_scale),
        page_table.data_ptr(), base.data_ptr(), shift, b, c, h, nkv,
        num_pages, ps, hd, page_table.shape[1], num_splits, out.data_ptr(),
        *part, stream_of(q))
    raise_on(rc, name)
    return out


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, *tensors) -> None:
    """Every tensor on one CUDA device and contiguous; raise otherwise."""
    dev = tensors[0].device
    if not tensors[0].is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def check_paged(name: str, q, k_pages, v_pages, page_table, base,
                k_scale, v_scale, q_ndim: int) -> None:
    """Validate what the paged attention kernels take; raise otherwise."""
    check_cuda(name, q)
    if q.dim() != q_ndim or k_pages.dim() != 4 or page_table.dim() != 2:
        raise ValueError(f"{name}: bad ranks q{tuple(q.shape)} "
                         f"k{tuple(k_pages.shape)} pt{tuple(page_table.shape)}")
    tensors = [q, k_pages, v_pages, page_table, base]
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: pass both k_scale and v_scale or neither")
    if k_scale is not None:
        tensors += [k_scale, v_scale]
        if k_pages.dtype != torch.int8:
            raise ValueError(f"{name}: scales given for a {k_pages.dtype} pool")
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
                or k_scale.shape != k_pages.shape[:3] \
                or v_scale.shape != k_pages.shape[:3]:
            raise ValueError(f"{name}: scales must be f32 {k_pages.shape[:3]}")
    elif k_pages.dtype == torch.int8:
        raise ValueError(f"{name}: an int8 pool needs k_scale/v_scale")
    check_cuda(name, *tensors)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q dtype {q.dtype} not f32/bf16")
    if k_pages.dtype not in DTYPE_CODES or v_pages.dtype != k_pages.dtype \
            or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: k/v pools {k_pages.dtype}"
                         f"{tuple(k_pages.shape)} / {v_pages.dtype}"
                         f"{tuple(v_pages.shape)}")
    if page_table.dtype != torch.int32 or base.dtype != torch.int32:
        raise ValueError(f"{name}: page_table and positions must be int32")
    b, hd = q.shape[0], q.shape[-1]
    nkv, _, ps, khd = k_pages.shape
    if khd != hd or q.shape[-2] % nkv or page_table.shape[0] != b \
            or base.shape != (b,):
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k_pages.shape)} pt{tuple(page_table.shape)} "
                         f"base{tuple(base.shape)} disagree")
    if hd % 32 or not 32 <= hd <= 256 or not 1 <= ps <= 64:
        raise ValueError(f"{name}: tile contract is hd % 32 == 0, "
                         f"32 <= hd <= 256, page_size <= 64; got hd={hd}, "
                         f"page_size={ps}")


def raise_on(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
