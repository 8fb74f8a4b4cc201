"""The port's plain paged-attention versions (decode, prefill, verify)
against the reference's jnp oracles and, once each, its Pallas kernels in
interpret mode: f32, bf16 and int8 pools, ragged lengths, and page-table
entries past the pool that both sides clamp.

Tolerances: f32 atol = rtol = 1e-5 (the same f32 arithmetic, summed in
another order); bf16 outputs compared in f32 at 2e-2 (one bf16 ulp of
outputs up to 2 is 7.8e-3, and the two frameworks round at different
places)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import decode_attention as jdec  # noqa: E402
from repro.kernels import kv_quant as jq  # noqa: E402
from repro.kernels import prefill_attention as jpre  # noqa: E402
from repro.kernels import verify_attention as jver  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402

B, H, KV, HD, PS, NPAGES, P = 3, 8, 2, 16, 4, 6, 24
WINDOW = 3                              # prefill chunk / verify window

TOL = {"f32": dict(atol=1e-5, rtol=1e-5), "int8": dict(atol=1e-5, rtol=1e-5),
       "bf16": dict(atol=2e-2, rtol=2e-2)}


def _case(pool_kind, seed=0):
    """numpy inputs: q for decode and for a window, pool leaves, a page
    table with two entries past the pool, ragged lengths and starts."""
    rng = np.random.RandomState(seed)
    q1 = rng.randn(B, H, HD).astype(np.float32)
    qw = rng.randn(B, WINDOW, H, HD).astype(np.float32)
    k = rng.randn(KV, P, PS, HD).astype(np.float32)
    v = rng.randn(KV, P, PS, HD).astype(np.float32)
    pt = rng.permutation(np.arange(1, P))[:B * NPAGES].reshape(B, NPAGES)
    pt = pt.astype(np.int32)
    pt[0, -1] = P + 3                   # clamped to P-1 by both sides
    pt[1, 2] = P
    lengths = np.array([NPAGES * PS, 11, 1], np.int32)
    starts = np.array([NPAGES * PS - WINDOW, 9, 0], np.int32)
    if pool_kind == "bf16":
        q1, qw, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
                        for a in (q1, qw, k, v))
    return q1, qw, k, v, pt, lengths, starts


def _jax_args(q, k, v, pt, base, pool_kind):
    dt = jnp.bfloat16 if pool_kind == "bf16" else jnp.float32
    args = [jnp.asarray(q, dt)]
    scales = {}
    if pool_kind == "int8":
        kq, ks = jq.quantize_rows(jnp.asarray(k))
        vq, vs = jq.quantize_rows(jnp.asarray(v))
        args += [kq, vq]
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        args += [jnp.asarray(k, dt), jnp.asarray(v, dt)]
    return args + [jnp.asarray(pt), jnp.asarray(base)], scales


def _torch_args(q, k, v, pt, base, pool_kind):
    dt = torch.bfloat16 if pool_kind == "bf16" else torch.float32
    args = [torch.from_numpy(q).to(dt)]
    scales = {}
    if pool_kind == "int8":
        kq, ks = tk.quantize_rows(torch.from_numpy(k))
        vq, vs = tk.quantize_rows(torch.from_numpy(v))
        args += [kq, vq]
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        args += [torch.from_numpy(k).to(dt), torch.from_numpy(v).to(dt)]
    return args + [torch.from_numpy(pt), torch.from_numpy(base)], scales


REFS = {
    "decode": (jdec.paged_decode_reference, tk.paged_decode_reference),
    "prefill": (jpre.paged_prefill_reference, tk.paged_prefill_reference),
    "verify": (jver.paged_verify_reference, tk.paged_verify_reference),
}


def _inputs(kind, pool_kind, seed=0):
    q1, qw, k, v, pt, lengths, starts = _case(pool_kind, seed)
    if kind == "decode":
        return q1, k, v, pt, lengths
    return qw, k, v, pt, starts


def _compare(got_jax, got_torch, pool_kind):
    np.testing.assert_allclose(got_torch.float().numpy(),
                               np.asarray(got_jax, np.float32),
                               **TOL[pool_kind])


@pytest.mark.parametrize("pool_kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("kind", ["decode", "prefill", "verify"])
def test_plain_version_matches_reference_oracle(kind, pool_kind):
    jref, tref = REFS[kind]
    inputs = _inputs(kind, pool_kind)
    jargs, jsc = _jax_args(*inputs, pool_kind)
    targs, tsc = _torch_args(*inputs, pool_kind)
    got_t = tref(*targs, **tsc)
    assert got_t.dtype == targs[0].dtype and got_t.shape == targs[0].shape
    _compare(jref(*jargs, **jsc), got_t, pool_kind)


@pytest.mark.parametrize("kind", ["decode", "prefill", "verify"])
def test_plain_version_matches_pallas_interpret(kind):
    """The Pallas kernels as the reference's suites run them on the CPU
    (interpret mode), decode and verify with two splits; int8 pool."""
    inputs = _inputs(kind, "int8", seed=1)
    jargs, jsc = _jax_args(*inputs, "int8")
    targs, tsc = _torch_args(*inputs, "int8")
    if kind == "decode":
        got_j = jdec.flash_decode(*jargs, **jsc, num_splits=2, interpret=True)
    elif kind == "prefill":
        got_j = jpre.flash_prefill(*jargs, **jsc, interpret=True)
    else:
        got_j = jver.flash_verify(*jargs, **jsc, num_splits=2, interpret=True)
    _compare(got_j, REFS[kind][1](*targs, **tsc), "int8")


def test_ops_entries_take_the_plain_version_on_cpu():
    """On CPU tensors the public entries are the plain versions; the kernel
    wrappers refuse CPU tensors instead of falling back."""
    inputs = _inputs("decode", "f32")
    targs, _ = _torch_args(*inputs, "f32")
    torch.testing.assert_close(tk.paged_decode_attention(*targs),
                               tk.paged_decode_reference(*targs))
    winputs = _inputs("verify", "f32")
    wargs, _ = _torch_args(*winputs, "f32")
    torch.testing.assert_close(tk.paged_verify_attention(*wargs),
                               tk.paged_verify_reference(*wargs))
    torch.testing.assert_close(tk.paged_prefill_attention(*wargs),
                               tk.paged_prefill_reference(*wargs))
    for fn, args in ((tk.flash_decode_fwd, targs),
                     (tk.flash_verify_fwd, wargs),
                     (tk.flash_prefill_fwd, wargs)):
        before = fn.launches
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*args)
        assert fn.launches == before


def test_verify_window_of_one_is_decode():
    q1, _, k, v, pt, lengths, _ = _case("f32")
    targs, _ = _torch_args(q1, k, v, pt, lengths, "f32")
    dec = tk.paged_decode_reference(*targs)
    ver = tk.paged_verify_reference(targs[0][:, None], *targs[1:4],
                                    targs[4] - 1)
    torch.testing.assert_close(ver[:, 0], dec, atol=1e-6, rtol=1e-6)


def test_default_num_splits_matches_reference():
    from repro_torch.kernels.decode_attention import default_num_splits
    for npages in (1, 2, 3, 5, 8, 12, 16, 32, 33, 64):
        for batch in (0, 1, 2, 4, 8, 32):
            for budget in (0, 8, 32):
                for target in (1, 4, 7):
                    kw = dict(target=target, batch=batch, split_budget=budget)
                    assert default_num_splits(npages, **kw) == \
                        jdec.default_num_splits(npages, **kw)
