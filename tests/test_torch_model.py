"""The port's transformer serving steps against the reference's on shared
weights: reduced yi-6b in float32, weights from the reference's
``init_params`` carried over by ``params_from_reference``. Two prefill
chunks (the second all padding for one request), three decode steps and one
verify window whose last row runs past its write limit.

Tolerances: logits within 1e-4 and pool pages within 1e-5 (float32, sums in
another order). An int8 pool may differ by one quantization step where a
value sits on a rounding edge: at most +-1, on at most 0.1% of elements,
with scales within 1e-5. Page 0, the write sink, is left out of the pool
comparison (its rows take colliding pad writes in either order)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, ModelConfig,  # noqa: E402
                                 get_config, get_reduced_config)
from repro_torch.models import (get_family, init_params,  # noqa: E402
                                params_from_reference)
from repro_torch.models.transformer import TransformerFamily  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

PS, C, NPAGES = 8, 8, 4
PLEN = [13, 6]


@pytest.fixture(scope="module")
def shared():
    jcfg = jax_reduced("yi-6b").replace(dtype="float32", page_size=PS)
    tcfg = get_reduced_config("yi-6b").replace(dtype="float32", page_size=PS)
    jparams = jax_init(jax_family(jcfg).layout(jcfg), jax.random.PRNGKey(0),
                       jcfg.param_dtype)
    fam = get_family(tcfg)
    tparams = params_from_reference(tcfg, fam.layout(tcfg),
                                    jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    steps = {
        "prefill": (jax.jit(jts.build_paged_prefill_step(jcfg)),
                    tts.build_paged_prefill_step(tcfg)),
        "decode": (jax.jit(jts.build_paged_decode_step(jcfg)),
                   tts.build_paged_decode_step(tcfg)),
        "verify": (jax.jit(jts.build_paged_verify_step(jcfg)),
                   tts.build_paged_verify_step(tcfg)),
    }
    return jcfg, tcfg, jparams, tparams, steps


def _compare_pool(jpool, tpool, kv_dtype):
    for name in jpool:
        j = np.asarray(jpool[name])[:, :, 1:]
        t = tpool[name].numpy()[:, :, 1:]
        if name in ("k", "v") and kv_dtype == "int8":
            diff = np.abs(j.astype(np.int32) - t.astype(np.int32))
            assert diff.max() <= 1, name
            assert (diff > 0).mean() <= 1e-3, name
        else:
            np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_steps_match_reference(shared, kv_dtype):
    jcfg, tcfg, jparams, tparams, steps = shared
    num_pages = 1 + len(PLEN) * NPAGES
    jpool = jax_family(jcfg).paged_pool(jcfg, num_pages, kv_dtype)
    tpool = get_family(tcfg).paged_pool(tcfg, num_pages, kv_dtype,
                                        device="cpu")
    pt = np.arange(1, num_pages, dtype=np.int32).reshape(len(PLEN), NPAGES)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, tcfg.vocab_size, size=n) for n in PLEN]

    def run(kind, batch):
        nonlocal jpool, tpool
        jnext, jlog, jpool = steps[kind][0](
            jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jpool)
        tnext, tlog, tpool = steps[kind][1](
            tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
            tpool)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=1e-4, err_msg=kind)
        _compare_pool(jpool, tpool, kv_dtype)
        return np.asarray(jnext), tnext.numpy()

    # -- two prefill chunks; request 1's second chunk is all padding -------
    first = np.zeros(len(PLEN), np.int32)
    for j in range(2):
        toks = np.zeros((len(PLEN), C), np.int32)
        for i, p in enumerate(prompts):
            seg = p[j * C:(j + 1) * C]
            toks[i, :len(seg)] = seg
        qs = np.full(len(PLEN), j * C, np.int32)
        batch = {"tokens": toks, "q_start": qs,
                 "kv_len": np.array(PLEN, np.int32), "page_table": pt,
                 "logit_idx": np.array(PLEN, np.int32) - 1 - qs}
        sink_before = tpool["k"][:, :, 0].clone()
        jn, tn = run("prefill", batch)
        np.testing.assert_array_equal(jn, tn)
        for i, n in enumerate(PLEN):
            if j * C <= n - 1 < (j + 1) * C:
                first[i] = tn[i]
        # pads wrote the sink page, never request 1's pages past its prompt
        assert not torch.equal(tpool["k"][:, :, 0], sink_before)
        rows = tpool["k"][:, :, pt[1]].reshape(
            tcfg.num_layers, tcfg.num_kv_heads, -1, tcfg.head_dim)
        assert not rows[:, :, PLEN[1]:].any()

    # -- three decode steps -------------------------------------------------
    cur, pos = first, np.array(PLEN, np.int32)
    for _ in range(3):
        jn, tn = run("decode", {"tokens": cur[:, None], "pos": pos,
                                "page_table": pt})
        np.testing.assert_array_equal(jn, tn)
        cur, pos = tn, pos + 1

    # -- one verify window; request 0's last row is past its write limit ---
    window = np.stack([cur, (cur + 1) % tcfg.vocab_size,
                       (cur + 2) % tcfg.vocab_size], axis=1).astype(np.int32)
    limit = np.array([pos[0] + 2, 64], np.int32)
    over = (pt[0, (pos[0] + 2) // PS], (pos[0] + 2) % PS)
    assert not tpool["k"][:, :, over[0], over[1]].any()
    sink_before = tpool["k"][:, :, 0].clone()
    jn, tn = run("verify", {"tokens": window, "pos": pos, "page_table": pt,
                            "write_limit": limit})
    np.testing.assert_array_equal(jn, tn)
    assert not tpool["k"][:, :, over[0], over[1]].any()
    assert not torch.equal(tpool["k"][:, :, 0], sink_before)


def test_layout_and_params_from_reference(shared):
    jcfg, tcfg, jparams, tparams, _ = shared
    assert tparams["layers"]["attn"]["wq"].shape == (
        tcfg.num_layers, tcfg.d_model, tcfg.num_heads, tcfg.head_dim)
    assert tparams["layers"]["ffn"]["norm"].dtype == torch.float32
    np.testing.assert_array_equal(
        tparams["layers"]["ffn"]["w_up"].numpy(),
        np.asarray(jparams["layers"]["ffn"]["w_up"]))
    bad = jax.tree.map(np.asarray, jparams)
    bad["final_norm"] = bad["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_reference(tcfg, get_family(tcfg).layout(tcfg), bad,
                              device="cpu")


def test_rmsnorm_and_rope_match_reference():
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    w = rng.randn(16).astype(np.float32)
    pos = np.array([[0, 3, 7, 100, 4095]] * 2, np.int32)
    np.testing.assert_allclose(
        tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jl.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        atol=1e-4, rtol=1e-5)


def test_init_params_on_device_and_unported_family():
    tcfg = get_reduced_config("yi-6b")
    fam = get_family(tcfg)
    a = init_params(tcfg, fam.layout(tcfg), seed=3, device="cpu")
    assert a["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert a["layers"]["attn"]["norm"].dtype == torch.float32
    assert float(a["layers"]["attn"]["wq"].float().abs().max()) <= 2.0 * (
        tcfg.num_layers * tcfg.d_model) ** -0.5 + 1e-2
    # the frontend families map to the transformer; an unknown one raises
    for family in ("vlm", "audio"):
        assert isinstance(get_family(tcfg.replace(family=family)),
                          TransformerFamily)
    with pytest.raises(ValueError, match="no family"):
        get_family(tcfg.replace(family="retrieval"))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_config_fields_match_reference(arch):
    """Every field of the port's config, full and reduced, equals the
    reference's, the frontend fields of hubert-xlarge and paligemma-3b
    among them (the port lacks the reference's attention-chunk and scan
    fields, and has none the reference lacks)."""
    import dataclasses
    from repro.configs.base import ModelConfig as JaxModelConfig
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    assert set(names) <= {f.name for f in dataclasses.fields(JaxModelConfig)}
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (get_reduced_config(arch), jax_reduced(arch))):
        assert {n: getattr(mine, n) for n in names} \
            == {n: getattr(ref, n) for n in names}


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mistral-nemo-12b",
                                  "starcoder2-7b", "olmoe-1b-7b",
                                  "arctic-480b", "xlstm-350m",
                                  "hubert-xlarge", "paligemma-3b"])
def test_count_params_matches_reference(arch):
    """Total and per-token active parameters of the full configs, from the
    layouts alone (nothing is allocated)."""
    from repro.models.registry import count_params as jax_count
    from repro_torch.models import count_params
    cfg, jcfg = get_config(arch), jax_config(arch)
    for active in (False, True):
        assert count_params(cfg, active_only=active) \
            == jax_count(jcfg, active_only=active)
    if cfg.num_experts:
        assert count_params(cfg, active_only=True) < count_params(cfg)
    assert round(count_params(get_config("olmoe-1b-7b")) / 1e9, 2) == 6.92


def test_greedy_argmax_on_bf16_logits_takes_the_first_tie():
    """Greedy tokens come from compute-dtype (bf16) logits; bf16 rounding
    makes ties common, and both frameworks take the first maximal index."""
    rng = np.random.RandomState(4)
    logits = torch.from_numpy(rng.randn(6, 64).astype(np.float32))
    logits[:, 40] = logits[:, 7] = logits.max() + 1.0         # exact ties
    logits[3, 50] = logits[3, 7] + 1e-3      # rounds onto the tie in bf16
    lb = logits.bfloat16()
    got = tts._argmax(lb).numpy()
    want = np.asarray(jnp.argmax(jnp.asarray(lb.float().numpy(),
                                             jnp.bfloat16), axis=-1))
    np.testing.assert_array_equal(got, want)
    assert (got == 7).all()
