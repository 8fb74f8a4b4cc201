"""The port's AdamW (``repro_torch.train.adamw``) and error-feedback gradient
compression (``grad_compress``) against the reference's, on the same numpy
parameters and gradients.

- ``update`` with f32 moments: parameters, m and v within 1e-6 relative of
  the reference's over three steps (the same f32 arithmetic in the same
  order; the reference's XLA may fuse it differently);
- with int8 moments: the scales within 1e-6 relative, and the int8 codes
  equal except for +-1 where a value sits at a rounding boundary, on f32
  leaves kept by ``QUANT_MIN_SIZE`` and on a leaf whose last axis is not a
  multiple of ``QBLOCK``;
- ``lr_at`` equal to the reference's at every step of a schedule;
- clipping: the norm reported before the clip, the update scaled by it;
- the quantization bound |x - deq(q(x))| <= scale / 2 as a hypothesis
  property (a few examples), int8 state at under 0.3 of the f32 bytes, and
  ``ef_step``'s error-feedback contracts against the reference's."""
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from hypothesis.extra import numpy as hnp  # noqa: E402

from repro.train import adamw as jadamw  # noqa: E402
from repro.train import grad_compress as jgc  # noqa: E402
from repro_torch.train import adamw, grad_compress  # noqa: E402

SHAPES = {"w": (16, 256), "emb": (16, 128), "norm": (256,), "odd": (64, 40)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    if isinstance(tree, (adamw.QTensor, jadamw.QTensor)):
        return {"q": np.asarray(tree.q), "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.detach() if isinstance(tree, torch.Tensor)
                      else tree)


def _run_both(cfg_kw, steps=3, seed=0):
    rng = np.random.default_rng(seed)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 10 ** rng.uniform(-3, 0)).astype(
        np.float32) for k, s in SHAPES.items()} for _ in range(steps)]
    jc, tc = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jadamw.init(jc, jp), adamw.init(tc, tp)
    for g in grads:
        jp, js, jm = jadamw.update(jc, {k: jnp.asarray(v) for k, v in
                                        g.items()}, js, jp)
        tp, ts, tm = adamw.update(tc, {k: torch.from_numpy(v) for k, v in
                                       g.items()}, ts, tp)
    return (jp, js, jm), (tp, ts, tm)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


CFG = dict(learning_rate=1e-2, warmup_steps=1, decay_steps=20,
           max_grad_norm=1.0)


def test_update_f32_matches_reference():
    (jp, js, jm), (tp, ts, tm) = _run_both(CFG)
    assert int(ts.step) == int(js.step) == 3
    for name in SHAPES:
        assert _rel(_np(tp[name]), _np(jp[name])) <= 1e-6, name
        assert _rel(_np(ts.m[name]), _np(js.m[name])) <= 1e-6, name
        assert _rel(_np(ts.v[name]), _np(js.v[name])) <= 1e-6, name
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    assert float(tm["lr"]) == float(jm["lr"])


def test_update_int8_matches_reference():
    (jp, js, _), (tp, ts, _) = _run_both(dict(CFG, state_dtype="int8"))
    for name in SHAPES:
        assert _rel(_np(tp[name]), _np(jp[name])) <= 1e-5, name
        for tm, jm in ((ts.m[name], js.m[name]), (ts.v[name], js.v[name])):
            quant = isinstance(jm, jadamw.QTensor)
            assert isinstance(tm, adamw.QTensor) == quant, name
            assert quant == (name in ("w", "emb")), name
            if not quant:
                assert _rel(_np(tm), _np(jm)) <= 1e-6, name
                continue
            assert tm.shape == jm.shape and tm.q.dtype == torch.int8
            assert _rel(_np(tm.scale), np.asarray(jm.scale)) <= 1e-6, name
            dq = np.abs(_np(tm.q).astype(int) - np.asarray(jm.q).astype(int))
            assert dq.max() <= 1, name


def test_lr_at_equals_reference():
    kw = dict(learning_rate=3e-4, warmup_steps=10, decay_steps=110,
              min_lr_ratio=0.1)
    jc, tc = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    for step in list(range(0, 130, 7)) + [10, 110]:
        assert float(adamw.lr_at(tc, step)) == float(jadamw.lr_at(jc, step))
    assert float(adamw.lr_at(tc, 0)) == 0.0


def test_grad_clipping():
    cfg = adamw.AdamWConfig(learning_rate=1.0, warmup_steps=0,
                            max_grad_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(16, 128)}
    state = adamw.init(cfg, params)
    huge = {"w": torch.full((16, 128), 1e6)}
    _, state, metrics = adamw.update(cfg, huge, state, params)
    assert float(metrics["grad_norm"]) > 1e6          # reported pre-clip
    # clipped to norm 1: m = (1 - b1) * g * clip
    clip = 1.0 / float(metrics["grad_norm"])
    np.testing.assert_allclose(state.m["w"].numpy(),
                               (1 - cfg.b1) * 1e6 * clip, rtol=1e-5)


@settings(max_examples=8, deadline=None)
@given(hnp.arrays(np.float32, (8, 256),
                  elements=st.floats(-1e3, 1e3, width=32)))
def test_property_quantization_error_bound(x):
    """|x - deq(q(x))| <= scale/2 per block (scale = blockmax/127)."""
    qt = adamw.quantize_blockwise(torch.from_numpy(x))
    back = adamw.dequantize_blockwise(qt).numpy()
    blocks = x.reshape(8, 256 // adamw.QBLOCK, adamw.QBLOCK)
    scale = np.abs(blocks).max(axis=-1, keepdims=True) / 127.0
    bound = np.broadcast_to(scale / 2 + 1e-7, blocks.shape).reshape(x.shape)
    assert np.all(np.abs(x - back) <= bound + 1e-6)


def test_int8_state_memory_is_quarter():
    cfg = adamw.AdamWConfig(state_dtype="int8")
    params = {"w": torch.zeros(1024, 1024)}
    state = adamw.init(cfg, params)
    q = state.m["w"]
    assert isinstance(q, adamw.QTensor) and q.q.dtype == torch.int8
    bytes_q = q.q.numel() * 1 + q.scale.numel() * 4
    assert bytes_q < 0.3 * params["w"].numel() * 4
    with pytest.raises(ValueError, match="QBLOCK"):
        adamw.quantize_blockwise(torch.zeros(4, 100))


def test_ef_step_contracts_and_reference():
    """Accumulated EF residual stays bounded; the compressed stream's sum
    plus the residual is the true stream's sum; each step equals the
    reference's within f32 rounding."""
    rng = np.random.default_rng(1)
    g_true = rng.normal(size=(4, 256)).astype(np.float32)
    state = grad_compress.init_compressor({"g": torch.zeros(4, 256)})
    jstate = jgc.init_compressor({"g": jnp.zeros((4, 256))})
    acc = np.zeros_like(g_true)
    steps = 24
    for _ in range(steps):
        ghat, state = grad_compress.ef_step({"g": torch.from_numpy(g_true)},
                                            state)
        jhat, jstate = jgc.ef_step({"g": jnp.asarray(g_true)}, jstate)
        np.testing.assert_allclose(ghat["g"].numpy(), np.asarray(jhat["g"]),
                                   rtol=1e-5, atol=1e-5)
        acc += ghat["g"].numpy()
    resid = state.residual["g"].numpy()
    np.testing.assert_allclose(acc + resid, g_true * steps, rtol=1e-4,
                               atol=1e-4)
    assert np.abs(resid).max() <= np.abs(g_true).max() + 1e-3
    x_hat, err = grad_compress.compress_decompress(torch.from_numpy(g_true))
    np.testing.assert_allclose((x_hat + err).numpy(), g_true, atol=1e-6)
