"""The port's int8 KV quantization is bit-identical to the reference's:
int8 rows and f32 scales equal exactly, exact .5 ties round half to even,
and all-zero rows quantize to zeros."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import kv_quant as jq  # noqa: E402
from repro_torch.kernels import kv_quant as tq  # noqa: E402


def _both_quantize(x):
    jq8, js = jq.quantize_rows(jnp.asarray(x))
    tq8, ts = tq.quantize_rows(torch.from_numpy(x))
    return (np.asarray(jq8), np.asarray(js)), (tq8.numpy(), ts.numpy())


def _tie_rows():
    """Rows whose amax is 127, so scale is exactly 1 and x / scale keeps
    every .5: round half to even must give 0, 2, -2, 2 for .5, 1.5, -2.5,
    2.5."""
    rows = np.zeros((3, 8), np.float32)
    rows[0] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    rows[1] = [-127, 10.5, 11.5, -12.5, 0, 0, 0, 0]
    return rows                          # rows[2] is all zeros


@pytest.mark.parametrize("case", ["random", "ties", "bf16"])
def test_quantize_rows_bit_identical(case):
    rng = np.random.RandomState(0)
    if case == "random":
        x = (rng.randn(2, 3, 5, 16) * rng.uniform(0.01, 10, (2, 3, 5, 1))
             ).astype(np.float32)
        x[0, 0, 0] = 0.0                 # an all-zero row
    elif case == "ties":
        x = _tie_rows()
    else:                                # bf16-representable inputs
        x = torch.from_numpy(rng.randn(4, 6, 16).astype(np.float32)) \
            .bfloat16().float().numpy()
    (jq8, js), (tq8, ts) = _both_quantize(x)
    assert tq8.dtype == np.int8 and ts.dtype == np.float32
    np.testing.assert_array_equal(jq8, tq8)
    np.testing.assert_array_equal(js, ts)
    if case == "ties":
        assert tq8[0].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
        assert not tq8[2].any() and ts[2] == np.float32(1e-12 / 127)


def test_dequantize_and_quantize_pool_match_reference():
    rng = np.random.RandomState(1)
    pool = {n: rng.randn(2, 3, 4, 2, 16).astype(np.float32)
            for n in ("k", "v")}
    jp = jq.quantize_pool({n: jnp.asarray(a) for n, a in pool.items()})
    tp = tq.quantize_pool({n: torch.from_numpy(a) for n, a in pool.items()})
    assert set(jp) == set(tp) == {"k", "v", "k_scale", "v_scale"}
    for n in jp:
        np.testing.assert_array_equal(np.asarray(jp[n]), tp[n].numpy())
    jd = jq.dequantize_rows(jp["k"], jp["k_scale"])
    td = tq.dequantize_rows(tp["k"], tp["k_scale"])
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
