"""The port's n-gram drafts equal the reference's exactly: bigram and
trigram keys, at positions 0, 1 and 2 (where ``hist[pos-1]`` wraps to the
last column) and deeper, over histories with repeats and periodic runs.
Neither the draft nor the dense attention of the Zamba2 shared block
builds a tensor from a host value, which on a GPU would synchronise the
stream on every call."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serve.drafting import build_ngram_draft as jax_draft  # noqa: E402
from repro_torch.serve.drafting import build_ngram_draft  # noqa: E402

HLEN = 24


def _hist(seed):
    rng = np.random.RandomState(seed)
    hist = rng.randint(0, 4, size=(8, HLEN)).astype(np.int32)
    hist[3, :10] = [5, 6, 5, 6, 5, 6, 5, 6, 5, 6]   # period-2 run
    hist[4, :6] = 9                                  # period-1 run
    hist[5, -1] = hist[5, 0]                         # wrap target at pos 0
    pos = np.array([0, 1, 2, 9, 5, 0, 17, HLEN - 1], np.int32)
    cur = hist[np.arange(8), pos]
    return hist, cur, pos


@pytest.mark.parametrize("ngram", [2, 3])
@pytest.mark.parametrize("k_spec", [1, 4, 7])
def test_drafts_identical(ngram, k_spec):
    for seed in range(4):
        hist, cur, pos = _hist(seed)
        want = np.asarray(jax_draft(HLEN, k_spec, ngram)(
            jnp.asarray(hist), jnp.asarray(cur), jnp.asarray(pos)))
        got = build_ngram_draft(HLEN, k_spec, ngram)(
            torch.from_numpy(hist), torch.from_numpy(cur),
            torch.from_numpy(pos))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_bad_ngram_rejected():
    with pytest.raises(ValueError, match="ngram"):
        build_ngram_draft(HLEN, 4, 4)


def test_serve_path_builds_no_device_scalars(monkeypatch):
    """``torch.tensor`` refused: an n-gram draft and the dense prefill and
    decode attention still run, and the draft still equals the
    reference's (the masks take Python scalars in ``torch.where``)."""
    from repro_torch.models import layers
    hist, cur, pos = _hist(1)
    want = np.asarray(jax_draft(HLEN, 4, 3)(
        jnp.asarray(hist), jnp.asarray(cur), jnp.asarray(pos)))
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 6, n, 8).astype(np.float32))
               for n in (4, 2, 2))
    step = torch.from_numpy(np.array([3, 5], np.int32))
    args = [torch.from_numpy(a) for a in (hist, cur, pos)]

    def refuse(*a, **kw):
        raise AssertionError("torch.tensor on the serve path")

    monkeypatch.setattr(torch, "tensor", refuse)
    got = build_ngram_draft(HLEN, 4, 3)(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    dense = layers.dense_attention(q, k, v, causal=True)
    dec = layers.decode_attention(q[:, :1], k, v, step)
    assert dense.shape == q.shape and dec.shape == (2, 1, 4, 8)
    assert torch.isfinite(dense).all() and torch.isfinite(dec).all()
