"""The backward kernels of flash attention and RMSNorm, checked on the CPU
where their CUDA code cannot run:

(a) ``attention_bwd_route``, which picks the flash-attention backward's
    kernels by dtype: bf16 at hd 64 or 128 -> "sm90" (the wgmma + TMA
    dK/dV and dQ kernels), f32 -> "cuda_core", a bf16 hd the tensor-core
    kernels do not take -> raises (never rerouted);
(b) the wrappers against a stand-in library: ``flash_attention_bwd`` calls
    the entry of its route (bf16 -> ``flash_attention_bwd_sm90``, f32 ->
    ``flash_attention_f32_bwd``) and counts the launch on it, and an
    off-contract bf16 call raises before any launch; ``rmsnorm_bwd`` calls
    the register kernel or the shared-memory one by D, as the forward does,
    and counts the launch on that path;
(c) a plain-torch emulation of the tensor-core backward's arithmetic --
    64-row tiles zero-filled past S, a row past S given lse = +inf (so its
    P is 0), S^T = K Q^T from bf16 operands summed in f32, P in the exp2
    domain, the causal and ragged-key masks, P and dS rounded to bf16
    before their products, f32 accumulators, the dK/dV block's loop over
    the group's heads in the kernel's order, dK and dQ scaled by
    1/sqrt(hd) at the end -- held against ``jax.vjp`` of the reference's
    ``chunked_attention`` in bf16, G 2, a ragged S of 96, causal and full,
    with rows whose scores reach +-30. Tolerance 2e-2 of each gradient's
    max |value| (chip_smoke's TOL_BF16): P and dS are rounded to bf16 (2^-9
    relative) before products of 64-96 terms, and the reference rounds its
    own intermediates to bf16 in other places.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jax_layers  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import _cuda, attention_bwd_route  # noqa: E402

TOL_BF16 = 2e-2
TILE = 64


# ---------------------------------------------------------------------------
# (a) routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 128, "sm90"),
    (torch.float32, 128, "cuda_core"),
    (torch.float32, 64, "cuda_core"),
    (torch.float32, 192, "cuda_core"),
])
def test_attention_bwd_route(dtype, hd, route):
    assert attention_bwd_route(dtype, hd) == route


@pytest.mark.parametrize("hd", [96, 192, 256])
def test_attention_bwd_route_raises_on_bf16_hd_outside_contract(hd):
    with pytest.raises(ValueError, match=r"hd in \(64, 128\)"):
        attention_bwd_route(torch.bfloat16, hd)


# ---------------------------------------------------------------------------
# (b) the wrappers against a stand-in library
# ---------------------------------------------------------------------------

class _StandInLibrary:
    """Records each entry called (and from which source) and returns 0."""

    def __init__(self):
        self.calls = []

    def load(self, source):
        self.source = source
        return self

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((self.source, entry, args)) or 0


@pytest.fixture
def stand_in(monkeypatch):
    """The wrappers on CPU tensors with the CUDA checks, library and stream
    replaced, and their launch counters restored afterwards."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_cuda, "check_cuda", lambda *a: None)
    monkeypatch.setattr(_cuda, "library", lib.load)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(tk.flash_attention_bwd, "launches", 0)
    monkeypatch.setattr(tk.flash_attention_bwd, "launches_by_route",
                        {"sm90": 0, "cuda_core": 0})
    monkeypatch.setattr(tk.rmsnorm_bwd, "launches", 0)
    monkeypatch.setattr(tk.rmsnorm_bwd, "launches_by_route",
                        {"registers": 0, "smem": 0})
    return lib


def _flash_bwd_call(dtype, *, b=2, s=96, h=4, nkv=2, hd=64, causal=True):
    q = torch.zeros(b, s, h, hd, dtype=dtype)
    k = torch.zeros(b, s, nkv, hd, dtype=dtype)
    lse = torch.zeros(b, h, s)
    return lambda: tk.flash_attention_bwd(q, k, k, q, q, lse, causal=causal)


@pytest.mark.parametrize("dtype,hd,causal,source,entry", [
    (torch.bfloat16, 128, True, "flash_attention_bwd_sm90.cu",
     "flash_attention_bwd_sm90"),
    (torch.bfloat16, 64, False, "flash_attention_bwd_sm90.cu",
     "flash_attention_bwd_sm90"),
    (torch.float32, 128, True, "flash_attention_bwd.cu",
     "flash_attention_f32_bwd"),
    (torch.float32, 96, False, "flash_attention_bwd.cu",
     "flash_attention_f32_bwd"),
])
def test_flash_bwd_wrapper_launches_its_route(stand_in, dtype, hd, causal,
                                              source, entry):
    dq, dk, dv = _flash_bwd_call(dtype, hd=hd, causal=causal)()
    assert dq.shape == (2, 96, 4, hd) and dq.dtype == dtype
    assert dk.shape == dv.shape == (2, 96, 2, hd) and dk.dtype == dtype
    [(got_source, got_entry, args)] = stand_in.calls
    assert (got_source, got_entry) == (source, entry)
    # (q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KV, hd,
    #  causal, stream)
    assert args[10:17] == (2, 96, 96, 4, 2, hd, int(causal)) \
        and len(args) == 18
    route = "sm90" if entry == "flash_attention_bwd_sm90" else "cuda_core"
    assert tk.launch_counts()["flash_attention_bwd"] == 1
    assert tk.launch_counts_by_route()["flash_attention_bwd"] == {
        "sm90": int(route == "sm90"), "cuda_core": int(route == "cuda_core")}


@pytest.mark.parametrize("dtype,hd,match", [
    (torch.bfloat16, 192, r"hd in \(64, 128\)"),
    (torch.bfloat16, 256, r"hd in \(64, 128\)"),
    (torch.float32, 48, "hd % 32 == 0"),
])
def test_off_contract_flash_bwd_raises_before_launch(stand_in, dtype, hd,
                                                     match):
    with pytest.raises(ValueError, match=match):
        _flash_bwd_call(dtype, hd=hd)()
    assert stand_in.calls == []
    assert tk.launch_counts()["flash_attention_bwd"] == 0
    assert tk.launch_counts_by_route()["flash_attention_bwd"] == {
        "sm90": 0, "cuda_core": 0}


@pytest.mark.parametrize("dtype,d,entry,route", [
    (torch.bfloat16, 2048, "rmsnorm_bwd_reg", "registers"),
    (torch.bfloat16, 8192, "rmsnorm_bwd_reg", "registers"),
    (torch.bfloat16, 8200, "rmsnorm_bwd_smem", "smem"),
    (torch.float32, 4096, "rmsnorm_bwd_reg", "registers"),
    (torch.float32, 5120, "rmsnorm_bwd_smem", "smem"),
    (torch.float32, 1000, "rmsnorm_bwd_reg", "registers"),
])
def test_rmsnorm_bwd_wrapper_picks_its_kernel_by_d(stand_in, dtype, d, entry,
                                                   route):
    x = torch.zeros(3, 5, d, dtype=dtype)
    dx, dw = tk.rmsnorm_bwd(x, torch.ones(d), x)
    assert dx.shape == x.shape and dx.dtype == dtype and dw.shape == (d,)
    [(source, got_entry, args)] = stand_in.calls
    assert (source, got_entry) == ("rmsnorm.cu", entry)
    # (x, dtype, w, g, dx, part, nparts, dw, rows, d, eps, stream)
    assert args[6] == 15 and args[8:10] == (15, d)
    assert tk.launch_counts_by_route()["rmsnorm_bwd"] == {
        "registers": int(route == "registers"), "smem": int(route == "smem")}


# ---------------------------------------------------------------------------
# (c) the tensor-core backward's arithmetic, emulated, against jax.vjp
# ---------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tiles(x, n):
    """(B, S, heads, hd) -> (B, n*TILE, heads, hd), zero-filled past S (as
    TMA fills a tile's rows past the tensor)."""
    pad = torch.zeros(x.shape[0], n * TILE - x.shape[1], *x.shape[2:])
    return torch.cat([x, pad], dim=1)


def _visible(q0, k0, s, causal, keys_by_row):
    """The mask of a 64 x 64 tile: keys past S never, and with ``causal``
    key <= row. (R, T) when ``keys_by_row`` is False, else (T, R)."""
    rows = torch.arange(q0, q0 + TILE)[:, None]
    keys = torch.arange(k0, k0 + TILE)[None, :]
    ok = (keys < s) & ((keys <= rows) if causal else True)
    return ok.T if keys_by_row else ok


def emulate_flash_bwd(q, k, v, o, do, lse, causal):
    """The dK/dV and dQ kernels' arithmetic on bf16 values held in f32.

    q, o, do (B,S,H,hd); k, v (B,S,KV,hd); lse (B,H,S) f32, the natural
    log-sum-exp of the scaled scores. Returns (dq, dk, dv) f32 before the
    kernels' final bf16 cast."""
    b, s, h, hd = q.shape
    nkv = k.shape[2]
    g = h // nkv
    n = -(-s // TILE)
    scale = 1.0 / math.sqrt(hd)
    scale_log2 = math.log2(math.e) * scale
    qt_, kt_, vt_, ot_, dot_ = (_tiles(x, n) for x in (q, k, v, o, do))
    # the delta pass, and the row statistics a row past S gets
    delta = torch.zeros(b, h, n * TILE)
    delta[..., :s] = (do * o).sum(-1).transpose(1, 2)
    lse2 = torch.full((b, h, n * TILE), math.inf)
    lse2[..., :s] = lse * math.log2(math.e)
    dq = torch.zeros(b, n * TILE, h, hd)
    dk = torch.zeros(b, n * TILE, nkv, hd)
    dv = torch.zeros_like(dk)
    for bi in range(b):
        for kvh in range(nkv):
            for kt in range(n):                      # a dK/dV block
                keys = slice(kt * TILE, (kt + 1) * TILE)
                kk, vv = kt_[bi, keys, kvh], vt_[bi, keys, kvh]
                acc_k, acc_v = torch.zeros(TILE, hd), torch.zeros(TILE, hd)
                for hh in range(kvh * g, (kvh + 1) * g):
                    for qt in range(kt if causal else 0, n):
                        rows = slice(qt * TILE, (qt + 1) * TILE)
                        qq, gg = qt_[bi, rows, hh], dot_[bi, rows, hh]
                        st = kk @ qq.T                       # (keys, rows)
                        p = torch.exp2(st * scale_log2
                                       - lse2[bi, hh, rows][None, :])
                        p = torch.where(_visible(qt * TILE, kt * TILE, s,
                                                 causal, True), p, 0.0)
                        ds = p * (vv @ gg.T - delta[bi, hh, rows][None, :])
                        acc_v += _bf16(p) @ gg
                        acc_k += _bf16(ds) @ qq
                dk[bi, keys, kvh] = acc_k * scale
                dv[bi, keys, kvh] = acc_v
        for hh in range(h):
            kvh = hh // g
            for qt in range(n):                      # a dQ block
                rows = slice(qt * TILE, (qt + 1) * TILE)
                qq, gg = qt_[bi, rows, hh], dot_[bi, rows, hh]
                acc = torch.zeros(TILE, hd)
                for kt in range(qt + 1 if causal else n):
                    keys = slice(kt * TILE, (kt + 1) * TILE)
                    kk, vv = kt_[bi, keys, kvh], vt_[bi, keys, kvh]
                    p = torch.exp2(qq @ kk.T * scale_log2
                                   - lse2[bi, hh, rows][:, None])
                    p = torch.where(_visible(qt * TILE, kt * TILE, s, causal,
                                             False), p, 0.0)
                    ds = p * (gg @ vv.T - delta[bi, hh, rows][:, None])
                    acc += _bf16(ds) @ kk
                dq[bi, rows, hh] = acc * scale
    return dq[:, :s], dk[:, :s], dv[:, :s]


def _forward(q, k, v, causal):
    """The forward kernel's outputs on bf16 values: O rounded to bf16 and
    the rows' f32 log-sum-exp."""
    b, s, h, hd = q.shape
    kr, vr = (x.repeat_interleave(h // k.shape[2], dim=2) for x in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q, kr) / math.sqrt(hd)
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), -1e30)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), vr)
    return _bf16(o), torch.logsumexp(sc, -1), sc


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_emulation_matches_jax_vjp(causal):
    rng = np.random.RandomState(20)
    b, s, h, nkv, hd = 2, 96, 4, 2, 64       # G 2, a ragged second tile
    q = rng.randn(b, s, h, hd).astype(np.float32)
    q[:, :8] *= 10.0                          # rows whose scores reach +-30
    k = rng.randn(b, s, nkv, hd).astype(np.float32)
    v = rng.randn(b, s, nkv, hd).astype(np.float32)
    do = rng.randn(b, s, h, hd).astype(np.float32)
    qb, kb, vb, dob = (_bf16(torch.from_numpy(x)) for x in (q, k, v, do))
    o, lse, scores = _forward(qb, kb, vb, causal)
    assert scores[scores > -1e29].abs().max() > 30

    def attn(q_, k_, v_):
        return jax_layers.chunked_attention(q_, k_, v_, causal=causal,
                                            q_chunk=32, kv_chunk=32)

    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    _, vjp = jax.vjp(attn, *bf)
    want = [np.asarray(x.astype(jnp.float32))
            for x in vjp(jnp.asarray(do, jnp.bfloat16))]
    got = emulate_flash_bwd(qb, kb, vb, o, dob, lse, causal)
    for name, gx, wx in zip(("dq", "dk", "dv"), got, want):
        err = np.abs(_bf16(gx).numpy() - wx).max() / np.abs(wx).max()
        assert err <= TOL_BF16, (name, err)
