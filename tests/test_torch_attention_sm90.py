"""The tensor-core (wgmma + TMA) attention kernels of the port, checked on
the CPU where their CUDA code cannot run:

(a) ``attention_route``, which picks the kernel of a flash-attention or
    paged call by dtype: bf16 q over bf16 or int8 K/V -> "sm90", f32 ->
    "cuda_core", a bf16 hd the wgmma kernels do not take -> raises; and
    the three paged wrappers (decode, prefill, verify), run against a
    stand-in library, calling the entry of their route with decode's shift
    of -1 and C = 1, verify's C = T, the split count and its scratch, and
    counting the launch on that route; off-contract bf16 calls raise
    without a launch;
(b) a plain-torch emulation of the kernels' arithmetic -- bf16 operands
    multiplied in f32 and scaled after the product, an online softmax over
    64-key tiles in the exp2 domain, P rounded to bf16 before PV, int8
    ``k_scale`` folded into S and ``v_scale`` into P while l sums the
    unscaled p; for decode and verify, split-KV: each split's tile walk
    from its first key, unnormalised partials (an empty split writes m =
    -1e30 log2(e), l = 0, o = 0) and the exp2-domain combine -- held
    against the JAX reference (``chunked_attention``, and the prefill's,
    decode's and verify's jnp oracles over bf16 and int8 pools), with rows
    whose scores reach +-30. Tolerance 2e-2 on bf16-valued outputs,
    chip_smoke's TOL_BF16 (P's bf16 rounding is 2^-9 relative; outputs up
    to ~4);
(c) ``_cuda._target``: a library's name changes when a shared header
    (``csrc/*.cuh``) changes, so an edited header is never served from a
    stale build.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import ref as jdec  # noqa: E402
from repro.kernels.prefill_attention import ref as jpf  # noqa: E402
from repro.kernels.verify_attention import ref as jver  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.kernels import (_cuda, attention_route, flash_decode_fwd,  # noqa: E402
                                 flash_prefill_fwd, flash_verify_fwd,
                                 quantize_pool)

TOL_BF16 = 2e-2
TILE = 64
MASK = -1e30
NEG2 = MASK * math.log2(math.e)        # the masked score in the exp2 domain


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


class _StandInLibrary:
    """Records each entry called (and from which source) and returns 0."""

    def __init__(self):
        self.calls = []

    def load(self, source="paged_attention.cu"):
        self.source = source
        return self

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((self.source, entry, args)) or 0


@pytest.fixture
def stand_in(monkeypatch):
    """The wrappers on CPU tensors with the CUDA checks, library and stream
    replaced, and their launch counters restored afterwards."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_cuda, "check_paged", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "library", lib.load)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    for fn in (flash_decode_fwd, flash_prefill_fwd, flash_verify_fwd):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_route",
                            {"sm90": 0, "cuda_core": 0})
    return lib


def _paged_call(kind, q_dtype, kv_dtype, *, b=2, t=5, h=8, nkv=2, hd=64,
                ps=16, npages=8, splits=4):
    q = torch.zeros((b, h, hd) if kind == "decode" else (b, t, h, hd),
                    dtype=q_dtype)
    pool = torch.zeros(nkv, b * npages + 1, ps, hd, dtype=kv_dtype)
    scales = {}
    if kv_dtype == torch.int8:
        scales = dict(k_scale=torch.ones(pool.shape[:3]),
                      v_scale=torch.ones(pool.shape[:3]))
    pt = torch.zeros(b, npages, dtype=torch.int32)
    base = torch.ones(b, dtype=torch.int32)
    fn = {"decode": flash_decode_fwd, "prefill": flash_prefill_fwd,
          "verify": flash_verify_fwd}[kind]
    kw = {} if kind == "prefill" else dict(num_splits=splits)
    return fn, lambda: fn(q, pool, pool, pt, base, **scales, **kw), q


@pytest.mark.parametrize("kind,q_dtype,kv_dtype,splits,entry", [
    ("decode", torch.bfloat16, torch.bfloat16, 4, "paged_attention_sm90_fwd"),
    ("decode", torch.bfloat16, torch.int8, 1, "paged_attention_sm90_fwd"),
    ("decode", torch.float32, torch.float32, 4, "paged_decode_fwd"),
    ("decode", torch.bfloat16, torch.float32, 4, "paged_decode_fwd"),
    ("verify", torch.bfloat16, torch.bfloat16, 8, "paged_attention_sm90_fwd"),
    ("verify", torch.float32, torch.int8, 4, "paged_verify_fwd"),
    ("prefill", torch.bfloat16, torch.int8, 1, "paged_attention_sm90_fwd"),
    ("prefill", torch.float32, torch.float32, 1, "paged_prefill_fwd"),
])
def test_paged_wrappers_launch_their_route(stand_in, kind, q_dtype, kv_dtype,
                                           splits, entry):
    fn, call, q = _paged_call(kind, q_dtype, kv_dtype, splits=splits)
    out = call()
    assert out.shape == q.shape and out.dtype == q.dtype
    route = "sm90" if entry == "paged_attention_sm90_fwd" else "cuda_core"
    [(source, got_entry, args)] = stand_in.calls
    assert got_entry == entry
    assert source == ("paged_attention_sm90.cu" if route == "sm90"
                      else "paged_attention.cu")
    assert fn.launches == 1
    assert fn.launches_by_route == {"sm90": int(route == "sm90"),
                                    "cuda_core": int(route == "cuda_core")}
    if route == "sm90":
        # (..., base, shift, B, C, H, KV, P, ps, hd, npages, splits, out,
        #  part_o, part_m, part_l, stream)
        shift, b, c = args[8:11]
        assert shift == (-1 if kind == "decode" else 0)
        assert (b, c) == (q.shape[0], 1 if kind == "decode" else q.shape[1])
        assert args[17] == splits
        parts = args[19:22]
        if splits > 1:                 # one scratch: o, then m, then l
            rows = b * 2 * splits * c * 4
            assert parts[1] - parts[0] == 4 * rows * 64
            assert parts[2] - parts[1] == 4 * rows
        else:
            assert parts == (None, None, None)


@pytest.mark.parametrize("kind,kw,match", [
    ("decode", dict(ps=4), "page_size"),
    ("verify", dict(ps=128), "page_size"),
    ("decode", dict(h=132, nkv=2), "G <= 64"),
    ("verify", dict(hd=96), r"hd in \("),
    ("prefill", dict(ps=4), "page_size"),
])
def test_off_contract_bf16_paged_calls_raise(stand_in, kind, kw, match):
    fn, call, _ = _paged_call(kind, torch.bfloat16, torch.bfloat16, **kw)
    with pytest.raises(ValueError, match=match):
        call()
    assert stand_in.calls == [] and fn.launches == 0


# ---------------------------------------------------------------------------
# (b) the kernels' arithmetic, emulated, against the JAX reference
# ---------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tile_step(state, q, k, v, visible, k_scale=None, v_scale=None):
    """One 64-key tile of the online softmax, exp2 domain, as the wgmma
    kernels run it: state (m, l, o) of R rows -> the updated state."""
    m, l, o = state
    scale_log2 = math.log2(math.e) / math.sqrt(q.shape[-1])
    s = q @ k.T                                           # f32 product
    if k_scale is not None:
        s = s * k_scale
    s = torch.where(visible, s * scale_log2, NEG2)
    m_new = torch.maximum(m, s.max(dim=1).values)
    alpha = torch.exp2(m - m_new)
    p = torch.exp2(s - m_new[:, None])
    pv = p * v_scale if v_scale is not None else p
    return (m_new, l * alpha + p.sum(dim=1),
            o * alpha[:, None] + _bf16(pv) @ v)            # P in bf16


def _empty_state(r, hd):
    return torch.full((r,), NEG2), torch.zeros(r), torch.zeros(r, hd)


def emulate_tiles(q, k, v, visible, k_scale=None, v_scale=None):
    """One 64-row tile's arithmetic as the wgmma kernels run it.

    q (R, hd), k/v (T, hd): bf16 values (int8 values for an int8 pool) in
    f32; visible (R, T) bool; k_scale/v_scale (T,) f32 or None. Returns
    (R, hd) f32 before the final bf16 cast."""
    state = _empty_state(*q.shape)
    for k0 in range(0, k.shape[0], TILE):
        sl = slice(k0, k0 + TILE)
        state = _tile_step(
            state, q, k[sl], v[sl], visible[:, sl],
            None if k_scale is None else k_scale[sl],
            None if v_scale is None else v_scale[sl])
    _, l, o = state
    return o / l.clamp_min(1e-20)[:, None]


def emulate_split(q, k, v, qpos, num_splits, ps, k_scale=None, v_scale=None):
    """A 64-row tile of one (b, kv) as the split-KV kernel runs it.

    q (R <= 64, hd), row r at position qpos[r]; k/v (npages*ps, hd) the
    gathered pages in position order (values as in ``emulate_tiles``);
    k_scale/v_scale (npages*ps,) or None. Split s owns the keys of pages
    [s*pps, (s+1)*pps); its tiles of 64 keys start at its first key and
    stop after the tile's last position (qpos.max()); keys past the split's
    end or on pages never loaded are masked (their rows are zeros here, and
    an unloaded page's scales 0, as the kernel sets them). Returns (out
    (R, hd) f32 before the bf16 cast, [(m, l, o) of each split])."""
    n, hd = k.shape
    width, last = n // num_splits, int(qpos.max())
    pad = torch.zeros(TILE, hd)
    parts = []
    for split in range(num_splits):
        k_beg, k_end = split * width, (split + 1) * width
        state = _empty_state(q.shape[0], hd)
        for k0 in range(k_beg, min(last + 1, k_end), TILE):
            keys = torch.arange(k0, k0 + TILE)
            loaded = (keys < k_end) & (keys // ps * ps <= last)
            idx = keys.clamp(max=n - 1)
            kt = torch.where(loaded[:, None], k[idx], pad)
            vt = torch.where(loaded[:, None], v[idx], pad)
            scales = [None if x is None else torch.where(loaded, x[idx], 0.0)
                      for x in (k_scale, v_scale)]
            visible = (keys[None] <= qpos[:, None]) & (keys < k_end)[None]
            state = _tile_step(state, q, kt, vt, visible, *scales)
        parts.append(state)
    if num_splits == 1:
        _, l, o = parts[0]
        return o / l.clamp_min(1e-20)[:, None], parts
    m = torch.stack([p[0] for p in parts])                  # (S, R)
    w = torch.exp2(m - m.max(dim=0).values.clamp_min(NEG2))
    l_tot = (w * torch.stack([p[1] for p in parts])).sum(dim=0)
    o_tot = (w[..., None] * torch.stack([p[2] for p in parts])).sum(dim=0)
    return o_tot / l_tot.clamp_min(1e-20)[:, None], parts


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


@pytest.mark.parametrize("num_splits", [1, 4, 32])
@pytest.mark.parametrize("pool_kind", ["bf16", "int8"])
@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_split_emulation_matches_oracle(kind, pool_kind, num_splits):
    """Decode (C = 1 at lengths - 1) and verify (C = T at pos) through the
    split-KV emulation, G 4, hd 64, ps 16, 32 pages a request: 4 splits of
    two tiles, 32 one-page splits narrower than a tile, or one. Request 0
    reads to the end of its table, whose last entry is out of range and
    clamps to P-1; request 1 has length 1 (decode) or pos 0 (verify);
    request 2 ends mid-page, its verify window crossing a page boundary so
    that two of its rows see no key of the one-page split they visit."""
    rng = np.random.RandomState(2)
    b, h, nkv, hd, ps, npages, t = 3, 8, 2, 64, 16, 32, 5
    g, span = h // nkv, npages * ps
    num_pages = b * npages + 1
    c = 1 if kind == "decode" else t
    q = _inputs(rng, (b, c, h, hd), hot_rows=0)
    q[:, :, :2] *= 10.0                  # two hot heads: scores past +-30
    kf = rng.randn(nkv, num_pages, ps, hd).astype(np.float32)
    vf = rng.randn(nkv, num_pages, ps, hd).astype(np.float32)
    pt = (rng.permutation(num_pages - 1)[:b * npages] + 1).reshape(b, npages)
    pt = pt.astype(np.int32)
    pt[0, npages - 1] = num_pages + 5            # clamps to P-1
    if kind == "decode":
        base = np.array([span, 1, 87], np.int32)           # lengths
        first = base - 1
    else:
        base = np.array([span - t, 0, 94], np.int32)       # pos
        first = base
    if pool_kind == "int8":
        pool = quantize_pool({"k": torch.from_numpy(kf),
                              "v": torch.from_numpy(vf)})
        jpool = [jnp.asarray(pool[x].numpy()) for x in ("k", "v")]
        jsc = {x: jnp.asarray(pool[x].numpy()) for x in ("k_scale", "v_scale")}
    else:
        pool = {x: _bf16(torch.from_numpy(a)) for x, a in (("k", kf),
                                                           ("v", vf))}
        jpool = [jnp.asarray(a, jnp.bfloat16) for a in (kf, vf)]
        jsc = {}
    jq = jnp.asarray(q[:, 0] if kind == "decode" else q, jnp.bfloat16)
    oracle = jdec.paged_decode_reference if kind == "decode" \
        else jver.paged_verify_reference
    want = jax.jit(oracle)(jq, *jpool, jnp.asarray(pt), jnp.asarray(base),
                           **jsc)
    want = np.asarray(want.astype(jnp.float32)).reshape(b, c, h, hd)

    qb = _bf16(torch.from_numpy(q))
    ptc = torch.from_numpy(pt).long().clamp(0, num_pages - 1)
    got = torch.empty(b, c, h, hd)
    hot, empty = 0.0, 0
    for bi in range(b):
        for kv in range(nkv):
            kk = pool["k"][kv, ptc[bi]].reshape(-1, hd).float()
            vv = pool["v"][kv, ptc[bi]].reshape(-1, hd).float()
            ks = vs = None
            if pool_kind == "int8":
                ks = pool["k_scale"][kv, ptc[bi]].reshape(-1)
                vs = pool["v_scale"][kv, ptc[bi]].reshape(-1)
            rq = qb[bi, :, kv * g:(kv + 1) * g].reshape(c * g, hd)
            qpos = int(first[bi]) + torch.arange(c * g) // g
            out, parts = emulate_split(rq, kk, vv, qpos, num_splits, ps,
                                       ks, vs)
            got[bi, :, kv * g:(kv + 1) * g] = out.reshape(c, g, hd)
            s = rq @ kk.T
            hot = max(hot, float((s if ks is None else s * ks).abs().max())
                      / math.sqrt(hd))
            for split, (m, l, o) in enumerate(parts):
                if split * (span // num_splits) > int(qpos.max()):
                    empty += 1                   # no visible key: weight 0
                    assert (m == NEG2).all() and (l == 0).all() \
                        and (o == 0).all()
    assert hot > 30
    assert empty > 0 or num_splits == 1
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
