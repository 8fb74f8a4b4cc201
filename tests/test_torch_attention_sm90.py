"""The tensor-core (wgmma + TMA) attention kernels of the port, checked on
the CPU where their CUDA code cannot run:

(a) ``attention_route``, which picks the kernel of a flash-attention or
    paged-prefill call by dtype: bf16 q over bf16 or int8 K/V -> "sm90",
    f32 -> "cuda_core", a bf16 hd the wgmma kernels do not take -> raises;
(b) a plain-torch emulation of the kernels' arithmetic -- bf16 operands
    multiplied in f32 and scaled after the product, an online softmax over
    64-key tiles in the exp2 domain, P rounded to bf16 before PV, int8
    ``k_scale`` folded into S and ``v_scale`` into P while l sums the
    unscaled p -- held against the JAX reference (``chunked_attention`` and
    the prefill's jnp oracle over an int8 pool), with rows whose scores
    reach +-30. Tolerance 2e-2 on bf16-valued outputs, chip_smoke's
    TOL_BF16 (P's bf16 rounding is 2^-9 relative; outputs up to ~4);
(c) ``_cuda._target``: a library's name changes when a shared header
    (``csrc/*.cuh``) changes, so an edited header is never served from a
    stale build.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.prefill_attention import ref as jpf  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.kernels import _cuda, attention_route, quantize_pool  # noqa: E402

TOL_BF16 = 2e-2
TILE = 64
MASK = -1e30


# ---------------------------------------------------------------------------
# (a) routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_dtype,kv_dtype,hd,route", [
    (torch.bfloat16, torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, torch.bfloat16, 256, "sm90"),
    (torch.bfloat16, torch.int8, 128, "sm90"),
    (torch.float32, torch.float32, 128, "cuda_core"),
    (torch.float32, torch.float32, 96, "cuda_core"),
    (torch.float32, torch.int8, 128, "cuda_core"),
    (torch.bfloat16, torch.float32, 128, "cuda_core"),
])
def test_attention_route(q_dtype, kv_dtype, hd, route):
    assert attention_route(q_dtype, kv_dtype, hd) == route


def test_attention_route_raises_on_bf16_hd_outside_contract():
    with pytest.raises(ValueError, match=r"hd in \(64, 128, 192, 256\)"):
        attention_route(torch.bfloat16, torch.bfloat16, 96)


# ---------------------------------------------------------------------------
# (b) the kernels' arithmetic, emulated, against the JAX reference
# ---------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_tiles(q, k, v, visible, k_scale=None, v_scale=None):
    """One 64-row tile's arithmetic as the wgmma kernels run it.

    q (R, hd), k/v (T, hd): bf16 values (int8 values for an int8 pool) in
    f32; visible (R, T) bool; k_scale/v_scale (T,) f32 or None. Returns
    (R, hd) f32 before the final bf16 cast."""
    hd = q.shape[-1]
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    neg = MASK * math.log2(math.e)
    r = q.shape[0]
    m = torch.full((r,), neg)
    l = torch.zeros(r)
    o = torch.zeros(r, hd)
    for k0 in range(0, k.shape[0], TILE):
        sl = slice(k0, k0 + TILE)
        s = q @ k[sl].T                                   # f32 product
        if k_scale is not None:
            s = s * k_scale[sl]
        s = torch.where(visible[:, sl], s * scale_log2, torch.tensor(neg))
        m_new = torch.maximum(m, s.max(dim=1).values)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[:, None])
        l = l * alpha + p.sum(dim=1)
        pv = p * v_scale[sl] if v_scale is not None else p
        o = o * alpha[:, None] + _bf16(pv) @ v[sl]          # P in bf16
        m = m_new
    return o / l.clamp_min(1e-20)[:, None]


def _inputs(rng, shape, hot_rows=0, hot_scale=10.0):
    x = rng.randn(*shape).astype(np.float32)
    if hot_rows:                     # rows whose scores reach +-30
        x[:, :hot_rows] *= hot_scale
    return x


def test_flash_emulation_matches_chunked_attention():
    rng = np.random.RandomState(0)
    b, s, h, nkv, hd = 2, 96, 4, 2, 64          # G 2, a ragged second tile
    q = _inputs(rng, (b, s, h, hd), hot_rows=8)
    k = _inputs(rng, (b, s, nkv, hd))
    v = _inputs(rng, (b, s, nkv, hd))
    qb, kb, vb = (_bf16(torch.from_numpy(x)) for x in (q, k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", qb,
                          kb.repeat_interleave(h // nkv, dim=2)) / math.sqrt(hd)
    assert scores.abs().max() > 30
    want = jax_layers.chunked_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), causal=True, q_chunk=32, kv_chunk=32)
    want = np.asarray(want.astype(jnp.float32))
    causal = torch.arange(s)[:, None] >= torch.arange(s)[None, :]
    got = torch.empty(b, s, h, hd)
    for bi in range(b):
        for hi in range(h):
            kv = hi // (h // nkv)
            for q0 in range(0, s, TILE):
                rows = slice(q0, q0 + TILE)
                got[bi, rows, hi] = emulate_tiles(
                    qb[bi, rows, hi], kb[bi, :, kv], vb[bi, :, kv],
                    causal[rows])
    np.testing.assert_allclose(_bf16(got).numpy(), want, atol=TOL_BF16,
                               rtol=0)


def test_prefill_emulation_matches_oracle_on_int8_pool():
    rng = np.random.RandomState(1)
    b, c, h, nkv, hd, ps, npages = 2, 8, 4, 2, 64, 16, 6   # 96 positions
    g = h // nkv
    num_pages = b * npages + 1
    q = _inputs(rng, (b, c, h, hd), hot_rows=2)
    kf = torch.from_numpy(rng.randn(nkv, num_pages, ps, hd).astype(np.float32))
    vf = torch.from_numpy(rng.randn(nkv, num_pages, ps, hd).astype(np.float32))
    pool = quantize_pool({"k": kf, "v": vf})
    pt = (rng.permutation(num_pages - 1)[:b * npages] + 1).reshape(b, npages)
    pt = pt.astype(np.int32)
    pt[0, npages - 1] = num_pages + 5            # clamps to P-1
    q_start = np.array([npages * ps - c, 37], np.int32)   # mid-page
    want = jpf.paged_prefill_reference(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(pool["k"].numpy()),
        jnp.asarray(pool["v"].numpy()), jnp.asarray(pt), jnp.asarray(q_start),
        k_scale=jnp.asarray(pool["k_scale"].numpy()),
        v_scale=jnp.asarray(pool["v_scale"].numpy()))
    want = np.asarray(want.astype(jnp.float32))

    qb = _bf16(torch.from_numpy(q))
    ptc = torch.from_numpy(pt).long().clamp(0, num_pages - 1)
    got = torch.empty(b, c, h, hd)
    hot = 0.0
    for bi in range(b):
        for kv in range(nkv):
            # gathered int8 values and their row scales, in position order
            kk = pool["k"][kv, ptc[bi]].reshape(-1, hd).float()
            vv = pool["v"][kv, ptc[bi]].reshape(-1, hd).float()
            ks = pool["k_scale"][kv, ptc[bi]].reshape(-1)
            vs = pool["v_scale"][kv, ptc[bi]].reshape(-1)
            # rows of (b, kv): query r // G, head kv*G + r % G
            rq = qb[bi, :, kv * g:(kv + 1) * g].reshape(c * g, hd)
            qpos = int(q_start[bi]) + torch.arange(c * g) // g
            visible = torch.arange(kk.shape[0])[None, :] <= qpos[:, None]
            hot = max(hot, float(((rq @ kk.T) * ks).abs().max()) / math.sqrt(hd))
            out = emulate_tiles(rq, kk, vv, visible, ks, vs)
            got[bi, :, kv * g:(kv + 1) * g] = out.reshape(c, g, hd)
    assert hot > 30
    np.testing.assert_allclose(_bf16(got).numpy(), want, atol=TOL_BF16,
                               rtol=0)


# ---------------------------------------------------------------------------
# (c) header edits rebuild
# ---------------------------------------------------------------------------

def test_library_name_tracks_shared_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    first = _cuda._target("k.cu")
    assert first.parent == tmp_path / "build"
    assert _cuda._target("k.cu") == first              # stable
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = _cuda._target("k.cu")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _cuda._target("k.cu") != second
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert len({first, second, _cuda._target("k.cu")}) == 3
