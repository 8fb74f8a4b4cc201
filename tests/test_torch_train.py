"""The port's training loss (``TransformerFamily.train_loss``) and all its
gradients against the reference's ``jax.value_and_grad(family.train_loss)``
in float32, from the same weights (the reference's ``init_params``, carried
over by ``params_from_reference`` as f32 master weights), on the same
numpy batch.

Reduced internlm2-1.8b (``remat="full"``: one torch.utils.checkpoint a
layer against the reference's jax.checkpoint), yi-6b, olmoe-1b-7b under
both ``moe_impl``s (the aux losses), ``logit_chunk`` dividing the sequence
and not (the reference's fallback), and ``loss_mask``. The loss within
1e-5 and every gradient leaf within 1e-4 of its max |value| (the same f32
arithmetic summed in another order). Also: the Zamba2 hybrid's
``train_loss`` and ``remat="dots"`` raise, naming what they wait on. The
microbatched step is checked in tests/test_torch_train_job.py."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import get_family, params_from_reference  # noqa: E402

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _pair(arch, seed=0, **kw):
    """(reference cfg, family, params) and the port's, from one init."""
    jcfg = jax_reduced(arch).replace(dtype="float32", **kw)
    tcfg = get_reduced_config(arch).replace(dtype="float32", **kw)
    jfam, tfam = jax_family(jcfg), get_family(tcfg)
    jp = jax_init(jfam.layout(jcfg), jax.random.PRNGKey(seed), "float32")
    tp = params_from_reference(tcfg, tfam.layout(tcfg),
                               jax.tree.map(np.asarray, jp), device="cpu",
                               dtype=tcfg.pdtype)
    for leaf in _flat(tp).values():
        leaf.requires_grad_(True)
    return (jcfg, jfam, jp), (tcfg, tfam, tp)


def _batch(vocab, mask=False, seed=0):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, vocab, (B, S)).astype(np.int32),
             "labels": rng.randint(0, vocab, (B, S)).astype(np.int32)}
    if mask:
        batch["loss_mask"] = (rng.rand(B, S) < 0.6).astype(np.float32)
    return batch


CASES = {
    "internlm2-1.8b remat full": ("internlm2-1.8b", {}, False),
    "yi-6b": ("yi-6b", {}, False),
    "olmoe-1b-7b einsum": ("olmoe-1b-7b", {}, False),
    "olmoe-1b-7b sort": ("olmoe-1b-7b", {"moe_impl": "sort"}, False),
    "logit_chunk 8": ("yi-6b", {"logit_chunk": 8}, False),
    "logit_chunk 6 ragged": ("yi-6b", {"logit_chunk": 6}, False),
    "loss_mask": ("yi-6b", {}, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_loss_and_grads_match_reference(case):
    arch, kw, mask = CASES[case]
    (jcfg, jfam, jp), (tcfg, tfam, tp) = _pair(arch, **kw)
    if arch == "internlm2-1.8b":
        assert tcfg.remat == jcfg.remat == "full"
    batch = _batch(tcfg.vocab_size, mask)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jfam.train_loss(jcfg, p, jb), has_aux=True))(jp)
    tloss, tmet = tfam.train_loss(
        tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= LOSS_TOL
    for k in jmet:
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), abs=LOSS_TOL,
                                               rel=LOSS_TOL), k
    if tcfg.num_experts:
        assert float(tmet["moe_lb_loss"]) > 0 and float(tmet["moe_z_loss"]) > 0
    jg = _flat(jax.tree.map(np.asarray, jgrads))
    tg = _flat(tp)
    assert set(jg) == set(tg)
    for name, want in jg.items():
        got = tg[name].grad.numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max()) / scale
        assert err <= GRAD_TOL, (name, err)


def test_zamba_train_loss_raises():
    cfg = get_reduced_config("zamba2-1.2b").replace(dtype="float32")
    with pytest.raises(NotImplementedError, match="SSD scan"):
        get_family(cfg).train_loss(cfg, {}, _batch(cfg.vocab_size))


def test_remat_dots_raises():
    (_, _, _), (tcfg, tfam, tp) = _pair("yi-6b", remat="dots")
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(tcfg.vocab_size).items()}
    with pytest.raises(NotImplementedError, match="Queue 1, item 5"):
        tfam.train_loss(tcfg, tp, batch)


def test_configs_carry_the_reference_training_fields():
    from repro.configs import ARCH_NAMES as JAX_ARCHS
    from repro.configs import get_config as jax_config
    from repro_torch.configs import ARCH_NAMES, get_config
    for arch in ARCH_NAMES:
        assert arch in JAX_ARCHS
        for get_t, get_j in ((get_config, jax_config),
                             (get_reduced_config, jax_reduced)):
            t, j = get_t(arch), get_j(arch)
            for f in ("param_dtype", "remat", "logit_chunk", "logit_dtype"):
                assert getattr(t, f) == getattr(j, f), (arch, f)
    assert get_config("arctic-480b").pdtype == torch.bfloat16
    assert get_reduced_config("internlm2-1.8b").remat == "full"
