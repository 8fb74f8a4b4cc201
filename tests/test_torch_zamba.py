"""The port's Zamba2 hybrid static-serve path against the reference on
shared weights: reduced zamba2-1.2b in float32, weights drawn with numpy
from a seed over the layout and carried over by ``params_from_reference``.

- ``mamba_block`` and ``attention_block``, prefill and one decode step:
  outputs and every cache leaf within 1e-4 (float32, sums in another order);
- ``ZambaFamily.prefill`` and three ``decode`` steps over two SSD chunks
  (``ssm_chunk=16``, S=32): logits within 1e-3, every cache leaf within
  1e-4;
- ``ServeEngine`` tokens against the reference ``ServeEngine`` at every
  step whose top-1 logit margin in a teacher-forced reference pass exceeds
  1e-4, up to the first that does not;
- where the two engines differ on purpose: the port grows only the
  attention caches, so batches padded to ``ssm_conv - 1`` or ``ssm_heads``
  tokens decode, and their greedy tokens equal the argmax of a full prefill
  over the growing sequence (ROADMAP.md, Queue 3)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.params import tree_map_specs as jax_map_specs  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.models import get_family, params_from_reference  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.params import tree_map_specs  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

OP = dict(atol=1e-4, rtol=1e-4)
LOGITS = dict(atol=1e-3, rtol=1e-3)
MARGIN = 1e-4
B, S, MAX_LEN = 2, 32, 48          # two SSD chunks of 16 in prefill


def _np_params(layout, seed):
    """Reference-scaled weights from numpy: zeros/ones leaves as specified,
    the others normal, clipped at 2 sigma, scaled by fan-in (1 for the
    embedding)."""
    rng = np.random.RandomState(seed)

    def leaf(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        std = 1.0 if spec.init == "embed" else \
            float(np.prod(spec.shape[:-1])) ** -0.5
        return (np.clip(rng.randn(*spec.shape), -2, 2) * std).astype(
            np.float32)

    return tree_map_specs(leaf, layout)



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The reduced models are a few KB wide: one intra-op thread a test
    process runs them fastest, and leaves the other workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced("zamba2-1.2b").replace(dtype="float32", ssm_chunk=16)
    tcfg = get_reduced_config("zamba2-1.2b").replace(dtype="float32",
                                                     ssm_chunk=16)
    layout = get_family(tcfg).layout(tcfg)
    np_params = _np_params(layout, seed=0)
    tparams = params_from_reference(tcfg, layout, np_params, device="cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    steps = (jax.jit(jts.build_prefill_step(jcfg)),
             jax.jit(jts.build_decode_step(jcfg)))
    return jcfg, tcfg, jparams, tparams, steps


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **tol,
                               err_msg=what)


def _layer0(tree):
    return {k: v[0] for k, v in tree.items()}


def _pad_attn(cache, rows):
    """Grow the attention caches (axis 2) by ``rows`` zero rows."""
    def grow(x):
        pad = [(0, 0)] * x.ndim
        pad[2] = (0, rows)
        return (jnp.pad(x, pad) if isinstance(x, jax.Array)
                else torch.nn.functional.pad(x, (0, 0, 0, 0, 0, rows)))
    return {**cache, "attn_k": grow(cache["attn_k"]),
            "attn_v": grow(cache["attn_v"])}


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def test_layout_and_groups_match_reference():
    jcfg, tcfg = jax_config("zamba2-1.2b"), get_config("zamba2-1.2b")
    jfam, fam = jax_family(jcfg), get_family(tcfg)
    assert fam.group_sizes(tcfg) == jfam.group_sizes(jcfg) \
        == [6, 6, 6, 6, 6, 6, 2]
    assert fam.n_shared_applications(tcfg) == 6
    shapes = jax_map_specs(lambda s: s.shape, jfam.layout(jcfg))
    assert tree_map_specs(lambda s: s.shape, fam.layout(tcfg)) == shapes
    specs = ssm.mamba_param_specs(tcfg)
    assert {k for k, s in specs.items() if s.dtype == "float32"} \
        == {"norm", "gate_norm", "dt_bias", "A_log", "D"}
    assert get_family(tcfg.replace(family="ssm", ssm_variant="xlstm")).name \
        == "xlstm"
    assert get_family(tcfg.replace(family="audio", ssm_variant="")).name \
        == "transformer"
    with pytest.raises(ValueError, match="no family"):
        get_family(tcfg.replace(family="ssm", ssm_variant=""))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def test_mamba_block_matches_reference(model):
    jcfg, tcfg, jparams, tparams, _ = model
    rng = np.random.RandomState(1)
    x = rng.randn(B, S, tcfg.d_model).astype(np.float32)
    x1 = rng.randn(B, 1, tcfg.d_model).astype(np.float32)
    jp, tp = _layer0(jparams["mamba"]), _layer0(tparams["mamba"])
    block = jax.jit(lambda p, x, c: jax_ssm.mamba_block(jcfg, p, x, cache=c))
    jy, jc = block(jp, jnp.asarray(x), None)
    ty, tc = ssm.mamba_block(tcfg, tp, torch.from_numpy(x))
    _close(ty, jy, OP, "prefill y")
    for name in ("conv", "ssm"):
        _close(tc[name], jc[name], OP, f"prefill {name}")
    jy, jc = block(jp, jnp.asarray(x1), jc)
    ty, tc = ssm.mamba_block(tcfg, tp, torch.from_numpy(x1), cache=tc)
    _close(ty, jy, OP, "decode y")
    for name in ("conv", "ssm"):
        _close(tc[name], jc[name], OP, f"decode {name}")


def test_attention_block_matches_reference(model):
    jcfg, tcfg, jparams, tparams, _ = model
    rng = np.random.RandomState(2)
    x = rng.randn(B, S, tcfg.d_model).astype(np.float32)
    x1 = rng.randn(B, 1, tcfg.d_model).astype(np.float32)
    jp, tp = jparams["shared"]["attn"], tparams["shared"]["attn"]
    block = jax.jit(lambda p, x, pos, c, dpos: jax_layers.attention_block(
        jcfg, p, x, pos, cache=c, decode_pos=dpos))
    jy, (jk, jv) = block(jp, jnp.asarray(x), jnp.arange(S), None, None)
    ty, (tk_, tv) = L.attention_block(tcfg, tp, torch.from_numpy(x),
                                      torch.arange(S))
    _close(ty, jy, OP, "prefill y")
    _close(tk_, jk, OP, "k")
    _close(tv, jv, OP, "v")
    pos = np.array([S, S + 3], np.int32)
    jcache = tuple(jnp.pad(c, [(0, 0), (0, 8), (0, 0), (0, 0)])
                   for c in (jk, jv))
    tcache = tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 8))
                   for c in (tk_, tv))
    jy, jcache = block(jp, jnp.asarray(x1), jnp.asarray(pos)[:, None],
                       jcache, jnp.asarray(pos))
    ty, tcache = L.attention_block(
        tcfg, tp, torch.from_numpy(x1), torch.from_numpy(pos)[:, None],
        cache=tcache, decode_pos=torch.from_numpy(pos))
    _close(ty, jy, OP, "decode y")
    for got, want in zip(tcache, jcache):
        _close(got, want, OP, "decode cache")


# ---------------------------------------------------------------------------
# the family and the engine
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_reference(model):
    jcfg, tcfg, jparams, tparams, (jprefill, jdecode) = model
    toks = np.random.RandomState(3).randint(0, tcfg.vocab_size,
                                            size=(B, S)).astype(np.int32)
    prefill, decode = tts.build_prefill_step(tcfg), tts.build_decode_step(tcfg)
    jlogits, jcache = jprefill(jparams, {"tokens": jnp.asarray(toks)})
    tlogits, tcache = prefill(tparams, {"tokens": torch.from_numpy(toks)})
    _close(tlogits, jlogits, LOGITS, "prefill logits")
    layout = get_family(tcfg).cache_layout(tcfg, B, S)
    leaves = {**tcache["mamba"], "attn_k": tcache["attn_k"],
              "attn_v": tcache["attn_v"]}
    assert {k: (tuple(t.shape), t.dtype) for k, t in leaves.items()} == \
        {**layout["mamba"], "attn_k": layout["attn_k"],
         "attn_v": layout["attn_v"]}
    jcache, tcache = _pad_attn(jcache, MAX_LEN - S), _pad_attn(tcache,
                                                               MAX_LEN - S)
    jtok = np.array(jnp.argmax(jlogits, -1), np.int32)
    for step in range(3):
        pos = np.full((B,), S + step, np.int32)
        jnext, jlogits, jcache = jdecode(
            jparams, {"tokens": jnp.asarray(jtok)[:, None],
                      "pos": jnp.asarray(pos)}, jcache)
        _, tlogits, tcache = decode(
            tparams, {"tokens": torch.from_numpy(jtok)[:, None],
                      "pos": torch.from_numpy(pos)}, tcache)
        _close(tlogits, jlogits, LOGITS, f"decode {step} logits")
        jtok = np.array(jnext)
    for name in ("attn_k", "attn_v"):
        _close(tcache[name], jcache[name], OP, name)
    for name in ("conv", "ssm"):
        _close(tcache["mamba"][name], jcache["mamba"][name], OP, name)


def _teacher_forced_margins(jcfg, jparams, toks, tokens):
    """Top-1 minus top-2 logit of the reference model at each generated
    step, with the reference's own tokens fed back after the left-padded
    prompts."""
    fam = jax_family(jcfg)

    @jax.jit
    def all_logits(params, seq):
        x = jax_layers.embed_tokens(jcfg, params, seq)
        x, _ = fam._forward(jcfg, params, x, jnp.arange(seq.shape[1]))
        return jax_layers.logits_fn(jcfg, params, x)

    seq = jnp.asarray(np.concatenate([toks, tokens], axis=1))
    logits = np.asarray(all_logits(jparams, seq), np.float64)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    return margin[:, toks.shape[1] - 1:-1]


def test_serve_engine_against_reference(model):
    """Prompts padded to S = 32 (neither ssm_heads nor ssm_conv - 1, where
    the reference engine is sound); the same prefill and decode shapes as
    the test above."""
    jcfg, tcfg, jparams, tparams, (jprefill, jdecode) = model
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, tcfg.vocab_size, size=n).tolist()
               for n in (S, 21)]
    max_new = MAX_LEN - S
    jeng = JaxServeEngine(jcfg, jparams, max_len=MAX_LEN)
    jeng._prefill, jeng._decode = jprefill, jdecode     # compiled already
    jtok = jeng.generate(prompts, max_new=max_new).tokens
    ttok = ServeEngine(tcfg, tparams, max_len=MAX_LEN,
                       device="cpu").generate(prompts,
                                              max_new=max_new).tokens
    assert ttok.shape == jtok.shape == (B, max_new)
    toks = np.zeros((B, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    margins = _teacher_forced_margins(jcfg, jparams, toks, jtok)
    compared = 0
    for want, got, margin in zip(jtok, ttok, margins):
        for i in range(max_new):
            if margin[i] <= MARGIN:
                break
            assert got[i] == want[i]
            compared += 1
    assert compared >= jtok.size // 2


@pytest.mark.parametrize("which", ["ssm_conv", "ssm_heads"])
def test_engine_grows_only_attention_caches(model, which):
    """A batch padded to ``ssm_conv - 1`` (3) or ``ssm_heads`` (8) tokens:
    the reference engine grows the conv tail or the SSM state with the
    attention caches there (and then misreads or crashes); the port decodes,
    and each greedy token is the argmax of a full prefill over the prompt
    and the tokens before it, wherever that argmax has a margin."""
    _, tcfg, _, tparams, _ = model
    plen = tcfg.ssm_conv - 1 if which == "ssm_conv" else tcfg.ssm_heads
    assert plen in (3, 8)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, tcfg.vocab_size, size=n).tolist()
               for n in (plen, plen - 1)]
    max_new = 4
    out = ServeEngine(tcfg, tparams, max_len=16, device="cpu").generate(
        prompts, max_new=max_new).tokens
    toks = np.zeros((B, plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    fam = get_family(tcfg)
    compared = 0
    for t in range(max_new):
        seq = torch.from_numpy(np.concatenate([toks, out[:, :t]], axis=1))
        logits, _ = fam.prefill(tcfg, tparams, {"tokens": seq})
        top2 = torch.topk(logits.double(), 2).values
        for i in range(B):
            if top2[i, 0] - top2[i, 1] > MARGIN:
                assert out[i, t] == int(logits[i].argmax())
                compared += 1
    assert compared >= out.size // 2


def test_engine_drops_the_last_decode_write_past_max_len(model):
    """The reference's last decode step writes at ``pos = max_len`` when the
    cache has exactly ``plen + max_new - 1`` rows; JAX drops that scatter
    and so does the port. Its token is never read, so the tokens equal a
    roomier run's."""
    _, tcfg, _, tparams, _ = model
    prompts = [[5, 6, 7, 8, 9], [1, 2, 3]]
    tight = ServeEngine(tcfg, tparams, max_len=5 + 4 - 1, device="cpu")
    roomy = ServeEngine(tcfg, tparams, max_len=16, device="cpu")
    np.testing.assert_array_equal(tight.generate(prompts, max_new=4).tokens,
                                  roomy.generate(prompts, max_new=4).tokens)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tight.generate([[1] * 9], max_new=1)


def test_static_launcher_and_devices(model, capsys):
    _, tcfg, _, tparams, _ = model
    from repro_torch.launch.serve import main
    main(["--arch", "zamba2-1.2b", "--device", "cpu", "--batch", "2",
          "--max-new", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "engine: static (cpu)" and len(lines) == 3
    with pytest.raises(SystemExit, match="requires a paged-decode family"):
        main(["--arch", "zamba2-1.2b", "--engine", "continuous", "--device",
              "cpu"])
    with pytest.raises(SystemExit, match="requires the continuous engine"):
        main(["--arch", "zamba2-1.2b", "--spec", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServeEngine(tcfg, tparams)


def test_engine_serves_a_ragged_last_ssd_chunk(model):
    """Longest prompt 130 at ``ssm_chunk`` 128: the scan's last chunk has 2
    rows. The reference asserts a multiple of the chunk and cannot prefill
    this batch; the port serves it. Its prefill logits are within 1e-4 of
    the same model at ``ssm_chunk`` 256 (one chunk, which the reference
    also serves: its prefill is held to the port's within 1e-3, as above),
    every SSM state within 1e-4, and each greedy token of the chunk-128
    engine is the argmax of a full chunk-256 prefill over the prompt and
    the tokens before it, wherever that argmax has a margin."""
    jcfg, tcfg, jparams, tparams, _ = model
    c128, c256 = tcfg.replace(ssm_chunk=128), tcfg.replace(ssm_chunk=256)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, tcfg.vocab_size, size=n).tolist()
               for n in (130, 97)]
    toks = np.zeros((B, 130), np.int64)
    for i, p in enumerate(prompts):
        toks[i, 130 - len(p):] = p
    batch = {"tokens": torch.from_numpy(toks)}
    logits, cache = get_family(c128).prefill(c128, tparams, batch)
    want, want_cache = get_family(c256).prefill(c256, tparams, batch)
    _close(logits, want.numpy(), OP, "chunk 128 vs 256 logits")
    _close(cache["mamba"]["ssm"], want_cache["mamba"]["ssm"].numpy(), OP,
           "chunk 128 vs 256 ssm state")
    jprefill = jax.jit(jts.build_prefill_step(jcfg.replace(ssm_chunk=256)))
    jlogits, _ = jprefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    _close(logits, jlogits, LOGITS, "port chunk 128 vs reference chunk 256")

    max_new = 4
    out = ServeEngine(c128, tparams, max_len=MAX_LEN + 100,
                      device="cpu").generate(prompts, max_new=max_new).tokens
    assert out.shape == (B, max_new)
    fam = get_family(c256)
    compared = 0
    for t in range(max_new):
        seq = torch.from_numpy(np.concatenate([toks, out[:, :t]], axis=1))
        step_logits, _ = fam.prefill(c256, tparams, {"tokens": seq})
        top2 = torch.topk(step_logits.double(), 2).values
        for i in range(B):
            if top2[i, 0] - top2[i, 1] > MARGIN:
                assert out[i, t] == int(step_logits[i].argmax())
                compared += 1
    assert compared >= out.size // 2
