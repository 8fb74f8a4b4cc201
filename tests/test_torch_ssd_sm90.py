"""The tensor-core (wgmma + TMA) SSD scan and the RMSNorm kernels' paths,
checked on the CPU where their CUDA code cannot run:

(a) ``ssd_route``, which picks the SSD scan's kernel by dtype (bf16 ->
    "sm90", f32 -> "cuda_core", a bf16 N or P the wgmma kernel does not
    take -> raises), and the wrapper run against a stand-in library:
    each route's entry called with its shapes, chunk and head group, the
    launch counted on that route, off-contract calls raising without a
    launch; ``head_block``; RMSNorm's choice of kernel by D;
(b) a plain-torch emulation of the tensor-core SSD kernel's arithmetic --
    C B^T once a chunk for a group of heads, W = C B^T . exp2(la_l - la_m)
    . dt_m on the lower triangle carried into W x as two bf16 parts (hi =
    bf16(W), lo = bf16(W - hi)), the carried term from h's bf16 copy, s x
    rounded to bf16 for the state product, the f32 state, and the rows of
    a chunk's 64-row tiles past its L (the next chunk's rows, or zeros
    past S, a ragged last chunk's L being S - c0) masked -- held against the JAX package's sequential oracle
    ``ssd_reference`` (y and the final state) and its Pallas ``ssd_scan``
    in interpret mode, and against the port's plain version where outputs
    exceed 4 (a bf16 ulp there is 0.031: a W rounded once to bf16 would
    put some of them a ulp off). Tolerance 2e-2, chip_smoke's TOL_BF16
    (each added rounding is 2^-9 relative, W's pair ~2^-16).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.mamba_scan.kernel import ssd_scan as j_ssd_scan  # noqa: E402
from repro.kernels.mamba_scan.ref import ssd_reference as j_ssd  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import _cuda, ssd_route  # noqa: E402
from repro_torch.kernels.mamba_scan.kernel import head_block  # noqa: E402
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_path  # noqa: E402

TOL_BF16 = dict(atol=2e-2, rtol=2e-2)
LOG2E = math.log2(math.e)


# ---------------------------------------------------------------------------
# (a) routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,n,p,route", [
    (torch.bfloat16, 64, 64, "sm90"),
    (torch.float32, 64, 64, "cuda_core"),
    (torch.float32, 16, 32, "cuda_core"),
])
def test_ssd_route(dtype, n, p, route):
    assert ssd_route(dtype, n, p) == route


@pytest.mark.parametrize("b,h,hb", [(8, 64, 4), (4, 64, 2), (2, 64, 1),
                                    (1, 64, 1), (8, 6, 1), (128, 2, 2)])
def test_head_block(b, h, hb):
    assert head_block(b, h) == hb


class _StandInLibrary:
    """Records each entry called and returns 0."""

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
    replaced, and the launch counters restored afterwards."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_cuda, "check_cuda", lambda *a: None)
    monkeypatch.setattr(_cuda, "library", lib.load)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(tk.ssd_scan, "launches", 0)
    monkeypatch.setattr(tk.ssd_scan, "launches_by_route",
                        {"sm90": 0, "cuda_core": 0})
    monkeypatch.setattr(tk.rmsnorm_fused, "launches", 0)
    return lib


def _ssd_call(dtype, *, b=2, s=96, h=8, p=64, n=64, chunk=32):
    x = torch.zeros(b, s, h, p, dtype=dtype)
    bc = torch.zeros(b, s, n, dtype=dtype)
    return lambda: tk.ssd_scan(x, torch.ones(b, s, h), torch.zeros(h), bc,
                               bc, chunk=chunk)


@pytest.mark.parametrize("dtype,s,chunk,entry", [
    (torch.bfloat16, 96, 32, "ssd_scan_sm90_fwd"),
    (torch.bfloat16, 40, 128, "ssd_scan_sm90_fwd"),
    (torch.float32, 96, 32, "ssd_scan_f32_fwd"),
    (torch.bfloat16, 130, 128, "ssd_scan_sm90_fwd"),   # ragged last chunk
    (torch.float32, 200, 128, "ssd_scan_f32_fwd"),
])
def test_ssd_wrapper_launches_its_route(stand_in, dtype, s, chunk, entry):
    y, h_final = _ssd_call(dtype, s=s, chunk=chunk)()
    assert y.shape == (2, s, 8, 64) and y.dtype == dtype
    assert h_final.shape == (2, 8, 64, 64) and h_final.dtype == torch.float32
    [(source, got_entry, args)] = stand_in.calls
    assert (source, got_entry) == ("ssd_scan.cu", entry)
    # (x, B, C, dt, a_log, y, h_final, B, S, H, P, N, chunk[, hb], stream)
    assert args[7:13] == (2, s, 8, 64, 64, min(chunk, s))
    route = "sm90" if entry == "ssd_scan_sm90_fwd" else "cuda_core"
    if route == "sm90":
        assert args[13] == head_block(2, 8) and len(args) == 15
    else:
        assert len(args) == 14
    assert tk.ssd_scan.launches == 1
    assert tk.launch_counts_by_route()["ssd_scan"] == {
        "sm90": int(route == "sm90"), "cuda_core": int(route == "cuda_core")}
    tk.reset_launch_counts()
    assert tk.launch_counts()["ssd_scan"] == 0
    assert tk.launch_counts_by_route()["ssd_scan"] == {"sm90": 0,
                                                       "cuda_core": 0}


@pytest.mark.parametrize("kw,match", [
    (dict(n=32), "N = P = 64"),
    (dict(p=128), "N = P = 64"),
    (dict(s=256, chunk=256), "chunk 256"),
    (dict(s=96, chunk=0), "must be >= 1"),
])
def test_off_contract_bf16_ssd_calls_raise(stand_in, kw, match):
    with pytest.raises(ValueError, match=match):
        _ssd_call(torch.bfloat16, **kw)()
    assert stand_in.calls == [] and tk.ssd_scan.launches == 0
    assert tk.ssd_scan.launches_by_route == {"sm90": 0, "cuda_core": 0}


@pytest.mark.parametrize("d,dtype,path", [
    (2048, torch.bfloat16, "registers"), (4096, torch.bfloat16, "registers"),
    (8192, torch.bfloat16, "registers"), (8193, torch.bfloat16, "smem"),
    (4097, torch.bfloat16, "registers"), (4096, torch.float32, "registers"),
    (4097, torch.float32, "smem"), (32768, torch.bfloat16, "smem"),
])
def test_rmsnorm_path(stand_in, d, dtype, path):
    assert rmsnorm_path(d, dtype) == path
    out = tk.rmsnorm_fused(torch.zeros(8, d, dtype=dtype), torch.ones(d))
    assert out.shape == (8, d) and out.dtype == dtype
    [(source, entry, args)] = stand_in.calls
    assert source == "rmsnorm.cu"
    assert entry == ("rmsnorm_reg_fwd" if path == "registers"
                     else "rmsnorm_smem_fwd")
    assert args[4:6] == (8, d) and tk.rmsnorm_fused.launches == 1


# ---------------------------------------------------------------------------
# (b) the tensor-core kernel's arithmetic, emulated
# ---------------------------------------------------------------------------

def _bf16(t):
    return t.to(torch.bfloat16).float()


def _tile(t, b, c0, rows):
    """``rows`` rows of (B,S,...) tensor t from c0, zero past S: what a TMA
    box of 64-row sub-tiles brings."""
    out = torch.zeros((rows,) + t.shape[2:])
    part = t[b, c0:c0 + rows]
    out[:part.shape[0]] = part
    return out


def ssd_sm90_emulation(x, dt, a_log, bm, cm, *, chunk, hb):
    """x, bm, cm bf16-valued f32; dt, a_log f32 -> (y bf16-valued, h_final
    f32), as ssd_sm90_kernel computes them."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    L = min(chunk, s)
    rows = 64 * math.ceil(L / 64)
    A = -torch.exp(a_log) * LOG2E                  # exp2 domain
    ar = torch.arange(rows)
    y = torch.zeros(b, s, h, p)
    h_final = torch.zeros(b, h, n, p)
    for bi in range(b):
        for h0 in range(0, h, hb):
            state = torch.zeros(hb, n, p)
            for c0 in range(0, s, L):
                lc = min(L, s - c0)                # a ragged last chunk: S - c0
                lower = (ar[None, :] <= ar[:, None]) & (ar[:, None] < lc)
                live = ar < lc
                ct, bt = _tile(cm, bi, c0, rows), _tile(bm, bi, c0, rows)
                cb = ct @ bt.T                     # once for the group
                for j in range(hb):
                    hh = h0 + j
                    d = torch.zeros(rows)
                    d[:lc] = dt[bi, c0:c0 + lc, hh]
                    la = torch.zeros(rows)
                    la[:lc] = torch.cumsum(d[:lc] * A[hh], 0)
                    seg = (la[:, None] - la[None, :]).masked_fill(
                        ~lower, -math.inf)
                    w = cb * torch.exp2(seg) * d[None, :]
                    w_hi = _bf16(w)
                    w = w_hi + _bf16(w - w_hi)         # two bf16 fragments
                    xt = _tile(x[:, :, hh], bi, c0, rows)
                    acc = torch.zeros(rows, p)
                    if c0 > 0:
                        e = torch.where(live, torch.exp2(la), 0.0)
                        acc = (ct @ _bf16(state[j])) * e[:, None]
                    acc = acc + w @ xt
                    y[bi, c0:c0 + lc, hh] = _bf16(acc[:lc])
                    sw = torch.where(live, torch.exp2(la[lc - 1] - la) * d,
                                     0.0)
                    state[j] = torch.exp2(la[lc - 1]) * state[j] \
                        + bt.T @ _bf16(xt * sw[:, None])
            h_final[bi, h0:h0 + hb] = state
    return y, h_final


def _inputs(b, s, h, p, n, seed, dt_scale=1.0):
    """bf16-valued inputs of order 1 (B and C scaled by N^-0.5), dt a
    softplus of a normal as the model makes it."""
    rng = np.random.RandomState(seed)
    bf = lambda a: _bf16(torch.from_numpy(a.astype(np.float32))).numpy()
    dt = np.log1p(np.exp(rng.randn(b, s, h))) * dt_scale
    return (bf(rng.randn(b, s, h, p)), dt.astype(np.float32),
            (rng.randn(h) * 0.5).astype(np.float32),
            bf(rng.randn(b, s, n) * n ** -0.5),
            bf(rng.randn(b, s, n) * n ** -0.5))


@pytest.mark.parametrize("s,chunk,hb,dt_scale,pallas", [
    (96, 32, 4, 1.0, True),      # three chunks; rows 32-63 the next chunk's
    (40, 40, 2, 1.0, False),     # one ragged chunk; rows 40-63 past S
    (96, 32, 1, 20.0, False),    # strong decay: exp(la) underflows
    (130, 128, 4, 1.0, False),   # a last chunk of 2 rows: its second box
                                 # (rows 192-255) wholly past S
    (40, 16, 2, 1.0, False),     # a last chunk of 8 rows of 16
])
def test_ssd_sm90_emulation_matches_reference(s, chunk, hb, dt_scale, pallas):
    args = _inputs(2, s, 4, 16, 16, seed=s + hb, dt_scale=dt_scale)
    y, h_final = ssd_sm90_emulation(*(torch.from_numpy(a) for a in args),
                                    chunk=chunk, hb=hb)
    want_y, want_h = j_ssd(*(jnp.asarray(a) for a in args))
    assert np.abs(np.asarray(want_y)).max() > 0.5      # outputs of order 1
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL_BF16)
    np.testing.assert_allclose(h_final.numpy(), np.asarray(want_h),
                               **TOL_BF16)
    if pallas:
        got = j_ssd_scan(*(jnp.asarray(a) for a in args), chunk=chunk,
                         head_block=4, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(got), **TOL_BF16)


def test_ssd_sm90_emulation_matches_plain_on_large_outputs():
    """Outputs up to ~16 (x times 4), where the plain version rounds y to
    bf16 in steps of up to 0.125: the kernel's f32 sums must land on the
    same bf16 values, within 2e-2."""
    x, dt, a_log, bm, cm = (torch.from_numpy(a) for a in
                            _inputs(1, 128, 8, 64, 64, seed=11))
    x = x * 4
    y, h_final = ssd_sm90_emulation(x, dt, a_log, bm, cm, chunk=128, hb=4)
    want_y, want_h = tk.ssd_chunked_reference(
        x.bfloat16(), dt, a_log, bm.bfloat16(), cm.bfloat16(), chunk=128)
    assert (want_y.float().abs() > 4).sum() > 50
    assert (y - want_y.float()).abs().max() <= 2e-2
    assert (h_final - want_h).abs().max() <= 2e-2
