"""The plain versions of the port's RMSNorm, dense flash attention and Mamba2
SSD scan against the reference's jnp oracles (``rmsnorm_reference``,
``attention_reference``, ``ssd_reference`` with its final state) and, at
tiny shapes, its Pallas kernels in interpret mode. The CUDA wrappers refuse
CPU tensors; their kernels are held against these plain versions on the
GPU by ``chip_smoke.py``.

Tolerances: f32 atol = rtol = 1e-5 for RMSNorm and attention (the same f32
arithmetic, summed in another order) and 1e-4 for the SSD scan (exp of
cumulative sums, chunked against sequential); bf16 outputs compared in f32
at 2e-2 (one bf16 ulp of outputs up to 2 is 7.8e-3, and the two frameworks
round at different places)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ref as jfa  # noqa: E402
from repro.kernels.mamba_scan import ref as jms  # noqa: E402
from repro.kernels.rmsnorm import ref as jrms  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_fwd as j_flash  # noqa: E402
from repro.kernels.mamba_scan.kernel import ssd_scan as j_ssd_scan  # noqa: E402
from repro.kernels.rmsnorm.kernel import rmsnorm_fused as j_rms_fused  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

# The closed-form oracles jitted (one compile a shape, not one an
# operation); the sequential SSD oracle stays eager (jitting unrolls it).
j_rms = jax.jit(jrms.rmsnorm_reference, static_argnames=("eps",))
j_attn = jax.jit(jfa.attention_reference, static_argnames=("causal",))
j_ssd = jms.ssd_reference

F32 = dict(atol=1e-5, rtol=1e-5)
SSD = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_plain_matches_oracle(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 48).astype(np.float32) * 3
    w = rng.randn(48).astype(np.float32)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    got = tk.rmsnorm_reference(_t(x, tdt), _t(w), eps=1e-6)
    assert got.dtype == tdt and got.shape == x.shape
    want = j_rms(jnp.asarray(x, jdt), jnp.asarray(w), eps=1e-6)
    _close(got, want, F32 if dtype == "f32" else BF16)
    # the op dispatches a CPU tensor to the plain version
    _close(tk.rmsnorm(_t(x, tdt), _t(w)), want, F32 if dtype == "f32"
           else BF16)


def test_rmsnorm_plain_matches_pallas_interpret():
    rng = np.random.RandomState(1)
    x = rng.randn(32, 16).astype(np.float32)
    w = rng.randn(16).astype(np.float32)
    want = j_rms_fused(jnp.asarray(x), jnp.asarray(w), 1e-6, block_rows=16,
                       interpret=True)
    _close(tk.rmsnorm_reference(_t(x), _t(w)), want, F32)


# ---------------------------------------------------------------------------
# Dense flash attention
# ---------------------------------------------------------------------------

def _qkv(b, sq, skv, h, kv, hd, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, h, hd).astype(np.float32),
            rng.randn(b, skv, kv, hd).astype(np.float32),
            rng.randn(b, skv, kv, hd).astype(np.float32))


@pytest.mark.parametrize("causal,kv", [(True, 2), (False, 4), (True, 1)])
def test_attention_plain_matches_oracle(causal, kv):
    q, k, v = _qkv(2, 9, 9 if causal else 13, 4, kv, 32, seed=2)
    got = tk.attention_reference(_t(q), _t(k), _t(v), causal=causal)
    want = j_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal)
    _close(got, want, F32)
    _close(tk.flash_attention(_t(q), _t(k), _t(v), causal=causal), want, F32)


def test_attention_plain_bf16_matches_oracle():
    q, k, v = _qkv(1, 12, 12, 4, 2, 32, seed=3)
    got = tk.attention_reference(*(_t(a, torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    want = j_attn(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    _close(got, want, BF16)


def test_attention_plain_matches_pallas_interpret():
    q, k, v = _qkv(1, 32, 32, 4, 2, 16, seed=4)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, block_q=16, block_k=16, interpret=True)
    _close(tk.attention_reference(_t(q), _t(k), _t(v)), want, F32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_attention_oracle_matches_reference(dtype):
    """The model's O(S^2) oracle keeps the reference's rounding of p to v's
    dtype; in f32 it equals ``chunked_attention`` (the flash op)."""
    q, k, v = _qkv(2, 12, 12, 4, 2, 32, seed=9)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    got = tl.dense_attention(*(_t(a, tdt) for a in (q, k, v)))
    want = jax.jit(jax_layers.dense_attention)(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    _close(got, want, F32 if dtype == "f32" else BF16)
    if dtype == "f32":
        _close(tl.chunked_attention(_t(q), _t(k), _t(v)), want, F32)


# ---------------------------------------------------------------------------
# Mamba2 SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, p).astype(np.float32),
            (np.abs(rng.randn(b, s, h)) * 0.2 + 0.01).astype(np.float32),
            rng.randn(h).astype(np.float32) * 0.5,
            rng.randn(b, s, n).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32))


@pytest.mark.parametrize("chunk", [8, 32, 12])
def test_ssd_plain_versions_match_oracle(chunk):
    """The chunked plain version (what the CPU path runs), y and the final
    state, against the sequential jnp oracle; chunk 12 does not divide
    S = 32, so the last chunk has 8 rows (the reference asserts a multiple;
    the port takes the ragged chunk)."""
    x, dt, a_log, bm, cm = _ssd_inputs(2, 32, 3, 8, 6, seed=5)
    want_y, want_h = j_ssd(*(jnp.asarray(a) for a in (x, dt, a_log, bm, cm)))
    args = [_t(a) for a in (x, dt, a_log, bm, cm)]
    y, h = tk.ssd_chunked_reference(*args, chunk=chunk)
    _close(y, want_y, SSD)
    _close(h, want_h, SSD)
    y, h = tk.mamba_chunk_scan(*args, chunk=chunk)
    _close(y, want_y, SSD)
    _close(h, want_h, SSD)


@pytest.mark.parametrize("s,chunk", [(130, 128), (200, 128), (40, 16)])
def test_ssd_plain_ragged_last_chunk_matches_oracle(s, chunk):
    """A last chunk of 2, 72 and 8 rows (the Zamba2 engine's chunk 128 at
    prompts of 130 and 200): y and the final state against the sequential
    oracle, which has no chunk, within 1e-4 in f32."""
    x, dt, a_log, bm, cm = _ssd_inputs(1, s, 2, 8, 6, seed=s)
    want_y, want_h = j_ssd(*(jnp.asarray(a) for a in (x, dt, a_log, bm, cm)))
    y, h = tk.mamba_chunk_scan(*(_t(a) for a in (x, dt, a_log, bm, cm)),
                               chunk=chunk)
    assert y.shape == (1, s, 2, 8) and h.shape == (1, 2, 6, 8)
    _close(y, want_y, SSD)
    _close(h, want_h, SSD)


def test_ssd_plain_bf16_matches_oracle():
    x, dt, a_log, bm, cm = _ssd_inputs(2, 32, 3, 8, 6, seed=7)
    bf = torch.bfloat16
    y, h = tk.ssd_chunked_reference(_t(x, bf), _t(dt), _t(a_log),
                                    _t(bm, bf), _t(cm, bf), chunk=16)
    assert y.dtype == bf and h.dtype == torch.float32
    want_y, _ = j_ssd(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt),
                      jnp.asarray(a_log), jnp.asarray(bm, jnp.bfloat16),
                      jnp.asarray(cm, jnp.bfloat16))
    _close(y, want_y, BF16)


def test_ssd_plain_matches_pallas_interpret():
    x, dt, a_log, bm, cm = _ssd_inputs(1, 32, 4, 16, 16, seed=8)
    want = j_ssd_scan(*(jnp.asarray(a) for a in (x, dt, a_log, bm, cm)),
                      chunk=16, head_block=4, interpret=True)
    y, _ = tk.ssd_chunked_reference(*(_t(a) for a in (x, dt, a_log, bm, cm)),
                                    chunk=16)
    _close(y, want, SSD)


# ---------------------------------------------------------------------------
# The CUDA wrappers take CUDA tensors only
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 32, 2, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.rmsnorm_fused(x, torch.ones(32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.ssd_scan(x, torch.ones(2, 32, 2), torch.zeros(2),
                    torch.zeros(2, 32, 4), torch.zeros(2, 32, 4), chunk=16)
    assert tk.launch_counts()["ssd_scan"] == 0
