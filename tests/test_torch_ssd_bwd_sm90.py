"""The tensor-core (wgmma + TMA) SSD-scan backward, checked on the CPU where
its CUDA code cannot run: a plain-torch emulation of
``csrc/ssd_scan_bwd_sm90.cu``'s arithmetic, pass by pass, with every bf16
rounding and hi/lo pair the kernel makes:

1. the walks: h across the chunks in order (h <- exp(la_last) h + B^T (s
   x)) and dh across them in reverse (from dh_final or zero; dh <-
   exp(la_last) dh + C^T (exp(la) dy)), the f32 row scales folded into B
   and C and carried as two bf16 parts (hi = bf16(v), lo = bf16(v - hi)),
   each chunk's state stored as such a pair;
2. the chunk body: a (batch, chunk, group of HB heads) over the 128-row
   tile a TMA box pair brings (a shorter chunk's tile holds the next
   chunk's rows, a ragged last chunk's zeros past S), every L x L and L x
   N x P product with f32 accumulators, h and dh' through their pairs,
   Q, C B^T G and x dy^T G rounded once to bf16 where they feed only dx,
   dB and dC, the masks at the chunk's own rows; dB and dC summed over
   the group's heads in head order;
3. the fixed-order sums over head groups and over (batch, chunk).

Held against ``jax.vjp`` of the JAX package's ``ssd_chunked`` at moderate
decay, and against the port's ``ssd_chunked_backward_reference`` under
strong decay (dt x 20, where the reference's vjp is NaN), with a nonzero
dh_final, a ragged last chunk and gradients above 4: dx, dB and dC within
2e-2 of each gradient's max |value| (chip_smoke's TOL_BF16), ddt and
da_log within 1e-4 (TOL_F32).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.ssm import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    ssd_chunked_backward_reference)

TOL_BF16, TOL_F32 = 2e-2, 1e-4
LOG2E = math.log2(math.e)
GRADS = ("dx", "ddt", "da_log", "dB", "dC")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _pair(t):
    """The two bf16 parts a value goes into a product as: hi + lo."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _tile(t, b, c0, rows):
    """``rows`` rows of (B,S,...) tensor t from c0, zero past S: what a TMA
    box of 64-row sub-tiles brings."""
    out = torch.zeros((rows,) + t.shape[2:])
    part = t[b, c0:c0 + rows]
    out[:part.shape[0]] = part
    return out


def _chunk_scalars(dt, a2, b, h, c0, lc, rows):
    """dt (zero past the chunk's lc rows), la in the exp2 domain (flat past
    them), and the row masks."""
    d = torch.zeros(rows)
    d[:lc] = dt[b, c0:c0 + lc, h]
    la = torch.zeros(rows)
    la[:lc] = torch.cumsum(d[:lc] * a2[h], 0)
    la[lc:] = la[lc - 1]
    return d, la, torch.arange(rows) < lc


def ssd_bwd_sm90_emulation(x, dt, a_log, bm, cm, dy, dh_final, *, chunk,
                           hb):
    """x, bm, cm, dy bf16-valued f32; dt, a_log, dh_final (or None) f32 ->
    (dx, ddt, da_log, dB, dC), dx, dB, dC bf16-valued, as the kernels'
    three passes compute them."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    L = min(chunk, s)
    nc = -(-s // L)
    rows = 64 * math.ceil(L / 64)
    a_nat = -torch.exp(a_log)
    a2 = a_nat * LOG2E
    ar = torch.arange(rows)

    # 1. the walks: h across the chunks in order, dh across them in reverse
    # (from dh_final or zero), each update exp(la_last) state + (B or C
    # scaled by its rows' f32 weights, as a hi/lo pair)^T (x or dy), each
    # state stored as a hi/lo pair before its chunk's update
    h_in = torch.zeros(b, h, nc, n, p)
    dh_out = torch.zeros(b, h, nc, n, p)
    for bi in range(b):
        for hh in range(h):
            fwd = torch.zeros(n, p)
            bwd = torch.zeros(n, p) if dh_final is None \
                else dh_final[bi, hh].clone()
            for k in range(nc):
                for c, st in ((k, fwd), (nc - 1 - k, bwd)):
                    c0 = c * L
                    lc = min(L, s - c0)
                    d, la, live = _chunk_scalars(dt, a2, bi, hh, c0, lc, rows)
                    if st is fwd:
                        h_in[bi, hh, c] = _pair(st)
                        if c + 1 < nc:
                            sv = torch.where(
                                live, torch.exp2(la[lc - 1] - la) * d, 0.0)
                            st.mul_(torch.exp2(la[lc - 1])).add_(
                                _pair(_tile(bm, bi, c0, rows) * sv[:, None]).T
                                @ _tile(x[:, :, hh], bi, c0, rows))
                    else:
                        dh_out[bi, hh, c] = _pair(st)
                        if c > 0:
                            ela = torch.where(live, torch.exp2(la), 0.0)
                            st.mul_(torch.exp2(la[lc - 1])).add_(
                                _pair(_tile(cm, bi, c0, rows) * ela[:, None]).T
                                @ _tile(dy[:, :, hh], bi, c0, rows))

    # 2. the chunk body
    ng = h // hb
    dx = torch.zeros(b, s, h, p)
    ddt = torch.zeros(b, s, h)
    db_part = torch.zeros(b, s, ng, n)
    dc_part = torch.zeros(b, s, ng, n)
    da_part = torch.zeros(b, nc, h)
    for bi in range(b):
        for c in range(nc):
            c0 = c * L
            lc = min(L, s - c0)
            bt, ct = _tile(bm, bi, c0, rows), _tile(cm, bi, c0, rows)
            below = ar[None, :] <= ar[:, None]              # m <= l
            strict = ar[None, :] < ar[:, None]              # m < l
            for g in range(ng):
                dc_acc = torch.zeros(rows, n)
                db_acc = torch.zeros(rows, n)
                for j in range(hb):
                    hh = g * hb + j
                    d, la, live = _chunk_scalars(dt, a2, bi, hh, c0, lc,
                                                 rows)
                    xt = _tile(x[:, :, hh], bi, c0, rows)
                    dyt = _tile(dy[:, :, hh], bi, c0, rows)
                    hq, dhq = h_in[bi, hh, c], dh_out[bi, hh, c]
                    lower = below & live[:, None]           # m <= l < lc
                    gm = torch.exp2((la[:, None] - la[None, :]).masked_fill(
                        ~lower, -math.inf))                 # G[l][m]
                    ela = torch.where(live, torch.exp2(la), 0.0)
                    em = torch.where(live, torch.exp2(la[lc - 1] - la), 0.0)
                    # rows l: dC and the row terms of dla
                    xdy = dyt @ xt.T                        # [l][m]
                    r = (ct @ bt.T) * gm * xdy
                    row_s = (r * strict * d[None, :]).sum(1)
                    temp = ela[:, None] * (dyt @ hq.T)
                    v = (ct * temp).sum(1)
                    temp = temp + _bf16(xdy * gm * d[None, :]) @ bt
                    dc_acc += temp
                    # rows m: dx, dB and the column terms
                    gt = gm.T                               # [m][l]
                    xt_dy = xt @ dyt.T                      # [m][l]
                    cbt = (bt @ ct.T) * gt
                    rt = cbt * xt_dy
                    col_s = (rt * strict.T).sum(1)
                    diag = torch.diagonal(rt)
                    bdh = bt @ dhq
                    u = em * (xt * bdh).sum(1)
                    tx = em[:, None] * bdh + _bf16(cbt) @ dyt
                    dx[bi, c0:c0 + lc, hh] = _bf16(d[:, None] * tx)[:lc]
                    tb = em[:, None] * (xt @ dhq.T) + _bf16(xt_dy * gt) @ ct
                    db_acc += d[:, None] * tb
                    # the scalars: dla, its reverse cumulative sum, ddt
                    hdh = (hq * dhq).sum()
                    k = lc - 1
                    dtu = d * u
                    dla = row_s - d * col_s + v - dtu
                    dla[k] = row_s[k] - d[k] * col_s[k] + v[k] \
                        + torch.exp2(la[k]) * hdh + dtu[:k].sum()
                    dla = torch.where(live, dla, 0.0)
                    cum = torch.flip(torch.cumsum(torch.flip(dla, [0]), 0),
                                     [0])
                    ddt[bi, c0:c0 + lc, hh] = (col_s + diag + u
                                               + a_nat[hh] * cum)[:lc]
                    da_part[bi, c, hh] = a_nat[hh] * (d * cum).sum()
                db_part[bi, c0:c0 + lc, g] = db_acc[:lc]
                dc_part[bi, c0:c0 + lc, g] = dc_acc[:lc]

    # 3. the fixed-order sums
    return (dx, ddt, da_part.sum((0, 1)), _bf16(db_part.sum(2)),
            _bf16(dc_part.sum(2)))


def _inputs(b, s, h, seed, dt_scale=1.0, x_scale=1.0, n=64, p=64):
    """bf16-valued x, B, C and dy of order 1 (B and C scaled by N^-0.5; x
    and dy by ``x_scale``), dt a softplus of a normal as the model makes it, a dh_final cotangent."""
    rng = np.random.RandomState(seed)
    bf = lambda a: _bf16(torch.from_numpy(a.astype(np.float32)))
    return (bf(rng.randn(b, s, h, p) * x_scale),
            torch.from_numpy((np.log1p(np.exp(rng.randn(b, s, h)))
                              * dt_scale).astype(np.float32)),
            torch.from_numpy((rng.randn(h) * 0.5).astype(np.float32)),
            bf(rng.randn(b, s, n) * n ** -0.5),
            bf(rng.randn(b, s, n) * n ** -0.5),
            bf(rng.randn(b, s, h, p) * x_scale),
            torch.from_numpy(rng.randn(b, h, n, p).astype(np.float32)))


def _check(got, want, tag):
    errs = {}
    for name, g, w in zip(GRADS, got, want):
        w = torch.from_numpy(np.array(w, np.float32))
        err = float((g.float() - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
        tol = TOL_F32 if name in ("ddt", "da_log") else TOL_BF16
        errs[name] = err
        assert err <= tol, (tag, name, err, tol)
    print(tag, {k: '%.2e' % v for k, v in errs.items()})
    return errs


def _jit(fn):
    """``jax.jit(fn)`` compiled with XLA's backend optimisations off."""
    return lambda *args: jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


@pytest.mark.parametrize("s,chunk,hb", [
    (256, 128, 4),       # two whole chunks of 128
    (192, 64, 2),        # 128-row tiles holding the next chunk's rows
])
def test_emulation_matches_jax_vjp(s, chunk, hb):
    """At moderate decay (dt / 4: the reference's exp above the diagonal,
    up to exp(sum of dt a over a chunk), overflows to a NaN vjp at the
    model's dt over 128 rows), every chunk whole (the reference asserts
    it)."""
    x, dt, a_log, bm, cm, dy, dh = _inputs(1, s, 4, seed=s + hb,
                                           dt_scale=0.25)
    zero_d = jnp.zeros(4, jnp.float32)

    def vjp(*args):
        _, back = jax.vjp(
            lambda *a: j_ssd_chunked(*a[:3], a[3], a[4], zero_d, chunk),
            *args[:5])
        return back(args[5:])

    want = _jit(vjp)(*(jnp.asarray(t.numpy()) for t in
                       (x, dt, a_log, bm, cm, dy, dh)))
    got = ssd_bwd_sm90_emulation(x, dt, a_log, bm, cm, dy, dh, chunk=chunk,
                                 hb=hb)
    _check(got, want, "jax.vjp")


@pytest.mark.parametrize("s,chunk,hb,dt_scale,x_scale,with_dh", [
    (200, 128, 4, 20.0, 1.0, True),   # strong decay, a ragged chunk of 72
    (130, 128, 2, 20.0, 1.0, False),  # ... of 2 rows, no h_final cotangent
    (96, 16, 4, 20.0, 1.0, True),     # chunk 16: a tile of 64 rows
    (256, 96, 4, 1.0, 6.0, True),     # gradients above 4; a chunk of 64
])
def test_emulation_matches_plain_backward(s, chunk, hb, dt_scale, x_scale,
                                          with_dh):
    x, dt, a_log, bm, cm, dy, dh = _inputs(1, s, 4, seed=s + chunk,
                                           dt_scale=dt_scale, x_scale=x_scale)
    dh = dh if with_dh else None
    want = ssd_chunked_backward_reference(x, dt, a_log, bm, cm, dy, dh,
                                          chunk=chunk)
    got = ssd_bwd_sm90_emulation(x, dt, a_log, bm, cm, dy, dh, chunk=chunk,
                                 hb=hb)
    if x_scale > 1:
        assert all(float(t.abs().max()) > 4 for t in
                   (want[0], want[3], want[4])), "gradients above 4"
    _check(got, [t.numpy() for t in want], "plain")
