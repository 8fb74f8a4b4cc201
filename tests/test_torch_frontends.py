"""The transformer's audio and VLM frontends in the port against the
reference on shared inputs: reduced hubert-xlarge (frame frontend,
encoder-only, bidirectional, plain GELU FFN) and paligemma-3b (patch
frontend, MQA, tied embeddings) in float32, weights from the reference's
``init_params`` carried over by ``params_from_reference``, inputs drawn
with numpy from a seed; the kernels' plain versions run on the CPU.

- ``_embed``'s frame and patch branches: activations and the text offset;
- hubert's ``build_encode_step``: per-frame logits within 1e-4;
- paligemma's ``prefill`` with patches, then three ``decode`` steps whose
  ``pos`` counts from the first patch (the reference's
  tests/test_consistency.py scenario): logits and caches within 1e-4;
- ``train_loss`` of both configs without remat or loss chunking
  (paligemma's drops the patch rows before the loss) within 1e-5
  relative;
- ``ServeEngine.generate`` on paligemma text prompts: tokens equal the
  reference engine's at every step whose top-1 logit margin exceeds 1e-4,
  up to the first that does not;
- the plain flash attention at hd 80 (HuBERT's width), causal and not,
  against the reference's ``chunked_attention``; the forward wrapper's
  routes at hd 80 against a stand-in library (bf16 and f32 entries with
  the true hd; a width outside the contract raises before any call);
- the serve launcher refuses the encoder-only arch as the reference's
  does;
- a reduced hubert-xlarge ``ElasticTrainer`` run on frames labelled with
  the nearest of ``vocab_size`` fixed random centroids (the card's
  training batches, HuBERT's kind of target), revoked after step 3 and
  resumed from the step-2 checkpoint: its final state bit for bit the
  uninterrupted run's, the loss falling."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint.checkpointer import _flatten  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import ObjectStore, VirtualClock  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.models import get_family, params_from_reference  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import AdamWConfig, ElasticTrainer  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
# The reference's functions are compiled without XLA's backend
# optimisations: at these sizes compiling, not running, is the file's
# time, and the f32 values stay within TOL.
FAST_XLA = {"xla_backend_optimization_level": 0}
MARGIN = 1e-4
B, S, TEXT, MAX_LEN = 2, 12, 6, 24     # frames; text tokens; cache rows
SERVE_LEN = 14                          # the engines' max_len: 8 new tokens


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("hubert-xlarge", "paligemma-3b")


@pytest.fixture(scope="module")
def models():
    """arch -> (jcfg, tcfg, jparams, tparams): both configs' reference
    weights from one compiled init (eagerly, each leaf's shape compiles
    on its own), carried over to the port."""
    jcfgs = {a: jax_reduced(a).replace(dtype="float32") for a in ARCHS}
    layouts = {a: jax_family(c).layout(c) for a, c in jcfgs.items()}
    jparams = _jit(lambda key: {
        a: jax_init(layouts[a], key, c.param_dtype)
        for a, c in jcfgs.items()})(jax.random.PRNGKey(0))
    built = {}
    for a, jcfg in jcfgs.items():
        tcfg = get_reduced_config(a).replace(dtype="float32")
        tparams = params_from_reference(
            tcfg, get_family(tcfg).layout(tcfg),
            jax.tree.map(np.asarray, jparams[a]), device="cpu")
        built[a] = (jcfg, tcfg, jparams[a], tparams)
    return built.__getitem__


def _jit(fn):
    """``jax.jit(fn)`` compiled with FAST_XLA, once for each set of
    argument shapes."""
    compiled = {}

    def call(*args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((x.shape, x.dtype) for x in leaves))
        if key not in compiled:
            compiled[key] = jax.jit(fn).lower(*args).compile(FAST_XLA)
        return compiled[key](*args)
    return call


def _inputs(cfg, seed):
    """numpy batch: hubert frames (B,S,F) with per-frame labels; paligemma
    patches (B,P,F), text tokens and labels (B,TEXT)."""
    rng = np.random.RandomState(seed)
    if cfg.frontend == "frame":
        return {"frames": rng.randn(B, S, cfg.frontend_dim).astype(np.float32),
                "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(
                    np.int32)}
    return {"patches": rng.randn(B, cfg.frontend_len,
                                 cfg.frontend_dim).astype(np.float32),
            "tokens": rng.randint(0, cfg.vocab_size, (B, TEXT)).astype(
                np.int32),
            "labels": rng.randint(0, cfg.vocab_size, (B, TEXT)).astype(
                np.int32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               **TOL, err_msg=what)


def _jax_embed(jcfg, jparams, batch):
    """The reference's ``_embed``, its text offset returned as an array."""
    return _jit(lambda p, b: jax_family(jcfg)._embed(jcfg, p, b))(
        jparams, _j(batch))


def test_embed_matches_reference(models):
    for arch in ARCHS:
        jcfg, tcfg, jparams, tparams = models(arch)
        batch = _inputs(tcfg, seed=1)
        jx, jpos, joff = _jax_embed(jcfg, jparams, batch)
        tx, tpos, toff = get_family(tcfg)._embed(tcfg, tparams, _t(batch))
        _close(tx, jx, f"{arch} embedding")
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        assert toff == int(joff) == (tcfg.frontend_len
                                     if arch == "paligemma-3b" else 0)
    text = {"tokens": batch["tokens"]}          # paligemma, text alone
    jx, _, joff = _jax_embed(jcfg, jparams, text)
    tx, _, toff = get_family(tcfg)._embed(tcfg, tparams, _t(text))
    _close(tx, jx, "text embedding")
    assert toff == int(joff) == 0


def test_hubert_encode_step_matches_reference(models):
    jcfg, tcfg, jparams, tparams = models("hubert-xlarge")
    frames = {"frames": _inputs(tcfg, seed=2)["frames"]}
    want = _jit(jts.build_encode_step(jcfg))(jparams, _j(frames))
    got = tts.build_encode_step(tcfg)(tparams, _t(frames))
    assert got.shape == (B, S, tcfg.vocab_size)
    _close(got, want, "encode logits")
    logits, cache = get_family(tcfg).prefill(tcfg, tparams, _t(frames))
    assert cache == {} and torch.equal(logits, got)


def test_paligemma_patch_prefill_then_decode_matches_reference(models):
    """Prefill 8 patches + 6 tokens, grow the cache to MAX_LEN, then three
    decode steps at pos 14, 15, 16 (counted from the first patch)."""
    jcfg, tcfg, jparams, tparams = models("paligemma-3b")
    batch = _inputs(tcfg, seed=3)
    batch.pop("labels")
    jfam, tfam = jax_family(jcfg), get_family(tcfg)
    jlogits, jcache = _jit(lambda p, b: jfam.prefill(jcfg, p, b))(
        jparams, _j(batch))
    tlogits, tcache = tfam.prefill(tcfg, tparams, _t(batch))
    _close(tlogits, jlogits, "prefill logits")
    rows = tcfg.frontend_len + TEXT
    assert tcache["k"].shape == (tcfg.num_layers, B, rows, 1, tcfg.head_dim)
    pad = MAX_LEN - rows
    jcache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, pad), (0, 0), (0, 0)])
              for k, v in jcache.items()}
    tcache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
              for k, v in tcache.items()}
    jdecode = _jit(jts.build_decode_step(jcfg))
    tdecode = tts.build_decode_step(tcfg)
    tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    for step in range(3):
        pos = np.full((B,), rows + step, np.int32)
        jnext, jlogits, jcache = jdecode(
            jparams, {"tokens": jnp.asarray(tok)[:, None],
                      "pos": jnp.asarray(pos)}, jcache)
        _, tlogits, tcache = tdecode(
            tparams, {"tokens": torch.from_numpy(tok)[:, None],
                      "pos": torch.from_numpy(pos)}, tcache)
        _close(tlogits, jlogits, f"decode {step} logits")
        tok = np.array(jnext)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], f"decode {name}")


def test_train_loss_matches_reference(models):
    for arch in ARCHS:
        jcfg, tcfg, jparams, tparams = models(arch)
        # remat and the loss's chunking are not what this test checks
        # (tests/test_torch_train.py holds the port's "full" remat and
        # ``logit_chunk``; paligemma's 640 exceeds the text, one chunk):
        # without them neither side compiles or imports checkpointing
        jcfg, tcfg = (c.replace(remat="none", logit_chunk=0)
                      for c in (jcfg, tcfg))
        batch = _inputs(tcfg, seed=4)
        jloss, _ = _jit(lambda p, b: jax_family(jcfg).train_loss(
            jcfg, p, b))(jparams, _j(batch))
        tloss, metrics = get_family(tcfg).train_loss(tcfg, tparams,
                                                     _t(batch))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5,
                                   err_msg=arch)
        assert float(metrics["loss"]) == float(tloss)


def test_paligemma_serve_engine_matches_reference(models):
    """Text prompts (no patches; neither reference engine takes them)."""
    jcfg, tcfg, jparams, tparams = models("paligemma-3b")
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, tcfg.vocab_size, size=n).tolist()
               for n in (TEXT, 4)]
    max_new = SERVE_LEN - TEXT
    jeng = JaxServeEngine(jcfg, jparams, max_len=SERVE_LEN)
    # the engine's own steps, compiled with FAST_XLA
    jeng._prefill = _jit(jts.build_prefill_step(jcfg))
    jeng._decode = _jit(jts.build_decode_step(jcfg))
    jtok = jeng.generate(prompts, max_new=max_new).tokens
    # the reference's own logits along its own tokens: each step's margin
    toks = np.array([[0] * (TEXT - len(p)) + p for p in prompts], np.int32)
    logits, cache = jeng._prefill(jparams, {"tokens": jnp.asarray(toks)})
    cache = jeng._pad_cache(cache, TEXT)
    margins = []
    for t in range(max_new):
        top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        pos = jnp.full((B,), TEXT + t, jnp.int32)
        _, logits, cache = jeng._decode(
            jparams, {"tokens": jnp.asarray(jtok[:, t])[:, None],
                      "pos": pos}, cache)
    margins = np.stack(margins, 1)
    ttok = ServeEngine(tcfg, tparams, max_len=SERVE_LEN,
                       device="cpu").generate(prompts,
                                              max_new=max_new).tokens
    assert ttok.shape == jtok.shape == (B, max_new)
    compared = 0
    for got, ref, margin in zip(ttok, jtok, margins):
        for i in range(max_new):
            if margin[i] <= MARGIN:
                break
            assert got[i] == ref[i]
            compared += 1
    assert compared >= jtok.size // 2


def test_flash_attention_hd80_matches_reference():
    rng = np.random.RandomState(6)
    q = rng.randn(2, 96, 4, 80).astype(np.float32)
    k = rng.randn(2, 96, 4, 80).astype(np.float32)
    v = rng.randn(2, 96, 4, 80).astype(np.float32)
    qkv = [jnp.asarray(x) for x in (q, k, v)]
    wants = _jit(lambda q, k, v: [jax_layers.chunked_attention(
        q, k, v, causal=causal, q_chunk=32, kv_chunk=32)
        for causal in (False, True)])(*qkv)
    for causal, want in zip((False, True), wants):
        got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5, err_msg=f"causal={causal}")


def test_flash_wrapper_routes_hd80(monkeypatch):
    """The forward wrapper against a stand-in library: hd 80 launches its
    dtype's entry with the true hd (the kernel pads it, not the wrapper);
    a width outside the contract raises, naming hd 80, before any call."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention import kernel as fk
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_cuda, "check_cuda", lambda *a: None)
    monkeypatch.setattr(_cuda, "library", lambda source: Lib())
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(fk.flash_attention_fwd, "launches", 0)
    monkeypatch.setattr(fk.flash_attention_fwd, "launches_by_route",
                        {"sm90": 0, "cuda_core": 0})
    for dtype, hd in ((torch.bfloat16, 96), (torch.float32, 72)):
        q = torch.zeros(2, 5, 4, hd, dtype=dtype)
        with pytest.raises(ValueError, match="80"):
            fk.flash_attention_fwd(q, q, q, causal=False)
    assert calls == []
    for dtype, entry in ((torch.bfloat16, "flash_attention_sm90_fwd"),
                         (torch.float32, "flash_attention_f32_fwd")):
        q = torch.zeros(2, 5, 4, 80, dtype=dtype)
        out = fk.flash_attention_fwd(q, q, q, causal=False)
        name, args = calls.pop()
        assert name == entry and args[4:11] == (2, 5, 5, 4, 4, 80, 0)
        assert out.shape == q.shape
    assert fk.flash_attention_fwd.launches == 2
    assert fk.flash_attention_fwd.launches_by_route \
        == {"sm90": 1, "cuda_core": 1}


def test_serve_launcher_refuses_encoder_only():
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit, match="hubert-xlarge is encoder-only "
                                         r"\(no decode step\)"):
        main(["--arch", "hubert-xlarge", "--device", "cpu"])


class _FrameBatches:
    """hubert's training batches, a pure function of the step (a restart
    replays them): standard normal frames from (seed, step), each labelled
    with the nearest of ``vocab_size`` fixed random centroids, and a
    Bernoulli(0.3) loss mask."""

    def __init__(self, cfg, batch, seq, seed=0):
        self.shape, self.seed = (batch, seq, cfg.frontend_dim), seed
        self.centroids = np.random.default_rng(seed).standard_normal(
            (cfg.vocab_size, cfg.frontend_dim), dtype=np.float32)

    def batch_at(self, step):
        rng = np.random.default_rng((self.seed, step))
        frames = rng.standard_normal(self.shape, dtype=np.float32)
        c = self.centroids
        labels = ((c * c).sum(-1) - 2.0 * (frames @ c.T)).argmin(-1)
        return {"frames": frames, "labels": labels.astype(np.int32),
                "loss_mask": (rng.random(self.shape[:2]) < 0.3).astype(
                    np.float32)}


def test_hubert_trainer_revocation_restart_bitwise_equal():
    cfg = get_reduced_config("hubert-xlarge")
    assert cfg.remat == "full"
    store = ObjectStore(clock=VirtualClock())
    loader = _FrameBatches(cfg, 4, 24)
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=2, decay_steps=50,
                      state_dtype="int8")
    ref = ElasticTrainer(cfg, opt, Checkpointer(store, "h-ref"), seed=0,
                         device="cpu")
    ref_rep = ref.train(loader, 4, checkpoint_every=2)
    rev = ElasticTrainer(cfg, opt, Checkpointer(store, "h-rev"), seed=0,
                         device="cpu")
    fired = []

    def revoke(step):
        if step == 3 and not fired:
            fired.append(step)
            return True
        return False

    rev_rep = rev.train(loader, 4, checkpoint_every=2, revoke_at=revoke)
    assert rev_rep.restarts == 1 and rev_rep.steps_run == 5
    assert ref_rep.losses[4] == rev_rep.losses[4] < ref_rep.losses[1]
    a = [t for _, t in _flatten(ref.final_state)]
    b = [t for _, t in _flatten(rev.final_state)]
    assert len(a) == len(b) > 0
    assert all(torch.equal(x.detach(), y.detach()) for x, y in zip(a, b))
