"""Training the Zamba2 hybrid on the port, checked on the CPU:

(a) the plain SSD-scan backward (``ssd_chunked_backward_reference``, the
    reverse chunk walk the CUDA kernel takes) against ``jax.vjp`` of the
    reference's ``repro.models.ssm.ssd_chunked`` (D-skip zero) with
    cotangents on y and h_final, at whole chunks (the reference asserts
    them), and against torch autograd of the port's plain forward on a
    ragged last chunk and at chunk 1; atol/rtol 1e-4 (f32 summed in
    another order);
(b) ``ZambaFamily.train_loss`` and every gradient against the reference's
    ``jax.value_and_grad(train_loss)`` on reduced zamba2-1.2b (remat
    "full", ssm_chunk 8, B 2, S 16: two chunks a layer) from the
    reference's ``init_params``: the loss within 1e-5, each leaf within
    1e-4 of its max |value|, as tests/test_torch_train.py holds them;
(c) ``SSDScan``'s routing against a stand-in library (the CUDA path on
    CPU tensors): a gradient-wanting call launches the forward on its
    dtype's route and, in backward, ``ssd_scan_bwd`` on its dtype's route
    (bf16 ``ssd_scan_bwd_sm90`` on ``sm90``, f32 ``ssd_scan_bwd_f32`` on
    ``cuda_core``), a call without a gradient the forward alone, and
    off-contract backward calls (a bf16 one off N = P = 64 or chunk <= 128
    too) raise before any launch;
(d) a reduced Zamba2 ``ElasticTrainer`` run revoked after step 3 and
    resumed from the step-2 checkpoint, bit for bit the uninterrupted
    run's after 4 steps.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro.models.ssm import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint.checkpointer import _flatten  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import ObjectStore, VirtualClock  # noqa: E402
from repro_torch.data import SyntheticCorpus, TokenLoader  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_chunk_scan, ssd_chunked_backward_reference, ssd_chunked_reference)
from repro_torch.kernels.mamba_scan.kernel import bwd_head_block  # noqa: E402
from repro_torch.models import get_family, params_from_reference  # noqa: E402
from repro_torch.train import AdamWConfig, ElasticTrainer  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
GRADS = ("dx", "ddt", "da_log", "dB", "dC")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The reduced shapes are a few KB wide: one intra-op thread a test
    process runs them fastest, and leaves the other workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(b, s, h, p, n, seed, dt_scale=1.0):
    """f32 inputs of order 1 (B and C scaled by N^-0.5), dt a softplus of a
    normal as the model makes it, and cotangents for y and h_final."""
    rng = np.random.RandomState(seed)
    f = lambda a: a.astype(np.float32)
    return (f(rng.randn(b, s, h, p)),
            f(np.log1p(np.exp(rng.randn(b, s, h))) * dt_scale),
            f(rng.randn(h) * 0.5), f(rng.randn(b, s, n) * n ** -0.5),
            f(rng.randn(b, s, n) * n ** -0.5), f(rng.randn(b, s, h, p)),
            f(rng.randn(b, h, n, p)))


def _jit(fn):
    """``jax.jit(fn)`` compiled with XLA's backend optimisations off: a
    quarter of the eager vjp's time at these shapes."""
    return lambda *args: jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


def _check(got, want, names=GRADS):
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), **TOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# (a) the plain backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [
    (16, 16),            # one chunk
    (32, 16),            # two
    (48, 8),             # six
])
def test_plain_backward_matches_jax_vjp(s, chunk):
    """At the model's decay: under strong decay the reference's vjp is NaN
    (its exp above the diagonal overflows before the mask zeroes it), so
    that case is held against autograd of the port's forward below."""
    x, dt, a_log, bm, cm, dy, dh = _scan_inputs(2, s, 3, 8, 4, seed=s)
    zero_d = jnp.zeros(3, jnp.float32)

    def vjp(*args):
        _, back = jax.vjp(
            lambda *a: j_ssd_chunked(*a[:3], a[3], a[4], zero_d, chunk),
            *args[:5])
        return back(args[5:])

    want = _jit(vjp)(*map(jnp.asarray, (x, dt, a_log, bm, cm, dy, dh)))
    got = ssd_chunked_backward_reference(
        *map(torch.from_numpy, (x, dt, a_log, bm, cm, dy)),
        torch.from_numpy(dh), chunk=chunk)
    _check(got, want)
    assert got[1].dtype == got[2].dtype == torch.float32


@pytest.mark.parametrize("s,chunk,dt_scale,with_dh", [
    (40, 16, 1.0, True),     # a ragged last chunk of 8 rows
    (40, 16, 1.0, False),    # ... with no h_final cotangent (zero)
    (7, 1, 1.0, True),       # chunk 1: every step a chunk
    (21, 8, 20.0, True),     # ragged under strong decay: exp(la)
    (24, 8, 20.0, False),    # underflows
])
def test_plain_backward_matches_autograd(s, chunk, dt_scale, with_dh):
    arrays = _scan_inputs(2, s, 3, 8, 4, seed=s + chunk, dt_scale=dt_scale)
    x, dt, a_log, bm, cm, dy, dh = map(torch.from_numpy, arrays)
    leaves = [t.clone().requires_grad_() for t in (x, dt, a_log, bm, cm)]
    y, hf = ssd_chunked_reference(*leaves, chunk=chunk)
    total = (y * dy).sum() + ((hf * dh).sum() if with_dh else 0.0)
    want = torch.autograd.grad(total, leaves)
    got = ssd_chunked_backward_reference(x, dt, a_log, bm, cm, dy,
                                         dh if with_dh else None, chunk=chunk)
    _check(got, want)


# ---------------------------------------------------------------------------
# (b) ZambaFamily.train_loss against the reference
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_train_loss_and_grads_match_reference():
    kw = dict(dtype="float32", ssm_chunk=8)
    jcfg = jax_reduced("zamba2-1.2b").replace(**kw)
    tcfg = get_reduced_config("zamba2-1.2b").replace(**kw)
    assert tcfg.remat == jcfg.remat == "full"
    jfam, tfam = jax_family(jcfg), get_family(tcfg)
    layout = jfam.layout(jcfg)
    jp = _jit(lambda key: jax_init(layout, key, "float32"))(
        jax.random.PRNGKey(0))
    tp = params_from_reference(tcfg, tfam.layout(tcfg),
                               jax.tree.map(np.asarray, jp), device="cpu",
                               dtype=tcfg.pdtype)
    for leaf in _flat(tp).values():
        leaf.requires_grad_(True)
    rng = np.random.RandomState(0)
    batch = {k: rng.randint(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = _jit(jax.value_and_grad(
        lambda p: jfam.train_loss(jcfg, p, jb), has_aux=True))(jp)
    tloss, tmet = tfam.train_loss(
        tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= LOSS_TOL
    assert tmet["loss"] is tloss
    jg = _flat(jax.tree.map(np.asarray, jgrads))
    tg = _flat(tp)
    assert set(jg) == set(tg)
    for name, want in jg.items():
        got = tg[name].grad.numpy()
        err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                    1e-30)
        assert err <= GRAD_TOL, (name, err)


# ---------------------------------------------------------------------------
# (c) SSDScan's routing against a stand-in library
# ---------------------------------------------------------------------------

class _StandInLibrary:
    """Records each entry called and returns 0."""

    def __init__(self):
        self.calls = []

    def load(self, source):
        self.source = source
        return self

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((self.source, entry, args)) or 0


@pytest.fixture
def stand_in(monkeypatch):
    """The CUDA path on CPU tensors: ``is_cuda`` true, the CUDA checks,
    library and stream replaced, the launch counters restored afterwards."""
    lib = _StandInLibrary()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(_cuda, "check_cuda", lambda *a: None)
    monkeypatch.setattr(_cuda, "library", lib.load)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    for fn in (tk.ssd_scan, tk.ssd_scan_bwd):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_route",
                            dict.fromkeys(("sm90", "cuda_core"), 0))
    return lib


def _scan_leaves(dtype, b=2, s=96, h=8, p=64, n=64):
    x = torch.zeros(b, s, h, p, dtype=dtype, requires_grad=True)
    dt = torch.ones(b, s, h, requires_grad=True)
    a_log = torch.zeros(h, requires_grad=True)
    bm = torch.zeros(b, s, n, dtype=dtype, requires_grad=True)
    cm = torch.zeros(b, s, n, dtype=dtype, requires_grad=True)
    return x, dt, a_log, bm, cm


@pytest.mark.parametrize("dtype,s,chunk,fwd_entry,use_h", [
    (torch.bfloat16, 96, 32, "ssd_scan_sm90_fwd", False),
    (torch.float32, 96, 32, "ssd_scan_f32_fwd", True),
    (torch.bfloat16, 130, 128, "ssd_scan_sm90_fwd", True),  # ragged
])
def test_scan_with_grad_launches_forward_then_backward(stand_in, dtype, s,
                                                        chunk, fwd_entry,
                                                        use_h):
    leaves = _scan_leaves(dtype, s=s)
    y, hf = mamba_chunk_scan(*leaves, chunk=chunk)
    assert [e for _, e, _ in stand_in.calls] == [fwd_entry]
    (y.float().sum() + (hf.sum() if use_h else 0.0)).backward()
    [fwd, (source, entry, args)] = stand_in.calls
    route = tk.ssd_route(dtype, 64, 64)
    assert route == ("sm90" if dtype == torch.bfloat16 else "cuda_core")
    if route == "sm90":
        assert (source, entry) == ("ssd_scan_bwd_sm90.cu",
                                   "ssd_scan_bwd_sm90")
    else:
        assert (source, entry) == ("ssd_scan_bwd.cu", "ssd_scan_bwd_f32")
    # (x, B, C, dt, a_log, dy, dh_final, work, dx, ddt, da_log, dB, dC,
    #  B, S, H, P, N, chunk[, head_block], stream)
    assert args[13:19] == (2, s, 8, 64, 64, chunk)
    assert (args[6] is not None) == use_h       # dh_final given or null
    assert len(args) == (21 if route == "sm90" else 20)
    if route == "sm90":
        assert args[19] == bwd_head_block(8) == 8
    assert tk.launch_counts()["ssd_scan_bwd"] == 1
    assert tk.launch_counts_by_route()["ssd_scan_bwd"] == {
        "sm90": int(route == "sm90"), "cuda_core": int(route == "cuda_core")}
    x, dt, a_log, bm, cm = leaves
    assert x.grad.dtype == dtype and x.grad.shape == x.shape
    assert dt.grad.shape == dt.shape and a_log.grad.shape == a_log.shape
    assert bm.grad.dtype == dtype and cm.grad.shape == cm.shape


def test_scan_without_grad_launches_forward_alone(stand_in):
    leaves = _scan_leaves(torch.bfloat16)
    with torch.no_grad():
        y, _ = mamba_chunk_scan(*leaves, chunk=32)
    assert not y.requires_grad
    mamba_chunk_scan(*(t.detach() for t in leaves), chunk=32)
    assert [e for _, e, _ in stand_in.calls] == ["ssd_scan_sm90_fwd"] * 2
    assert tk.launch_counts()["ssd_scan_bwd"] == 0


@pytest.mark.parametrize("kw,match", [
    (dict(chunk=256, s=256), "chunk 256"),
    (dict(n=256), "N 256"),
    (dict(p=32), "P 32"),
    (dict(dy_dtype=torch.bfloat16), "dy"),
    (dict(dh_shape=(2, 8, 64, 32)), "dh_final"),
    (dict(dtype=torch.bfloat16, n=32), "N = P = 64"),    # the wgmma route
    (dict(dtype=torch.bfloat16, p=128), "N = P = 64"),
    (dict(dtype=torch.bfloat16, chunk=256, s=256), "chunk 256"),
])
def test_off_contract_backward_raises_before_launch(stand_in, kw, match):
    s, n, p = kw.get("s", 64), kw.get("n", 64), kw.get("p", 64)
    dtype = kw.get("dtype", torch.float32)
    x, dt, a_log, bm, cm = (t.detach() for t in _scan_leaves(
        dtype, s=s, n=n, p=p))
    dy = torch.zeros_like(x, dtype=kw.get("dy_dtype", dtype))
    dh = torch.zeros(kw.get("dh_shape", (2, 8, n, p)))
    with pytest.raises(ValueError, match=match):
        tk.ssd_scan_bwd(x, dt, a_log, bm, cm, dy, dh, chunk=kw.get("chunk",
                                                                   32))
    assert stand_in.calls == [] and tk.launch_counts()["ssd_scan_bwd"] == 0


# ---------------------------------------------------------------------------
# (d) a revoked Zamba2 training run, bit for bit
# ---------------------------------------------------------------------------

def _state_leaves(state):
    return [t for _, t in _flatten(state)]


def test_trainer_revocation_restart_bitwise_equal():
    cfg = get_reduced_config("zamba2-1.2b").replace(ssm_chunk=16)
    store = ObjectStore(clock=VirtualClock())
    keys = SyntheticCorpus.build(store, "z", num_shards=1,
                                 tokens_per_shard=4096,
                                 vocab_size=cfg.vocab_size)
    loader = TokenLoader(store.get, keys, batch_size=4, seq_len=40)
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=2, decay_steps=50,
                      state_dtype="int8")
    ref = ElasticTrainer(cfg, opt, Checkpointer(store, "z-ref"), seed=0,
                         device="cpu")
    ref_rep = ref.train(loader, 4, checkpoint_every=2)
    rev = ElasticTrainer(cfg, opt, Checkpointer(store, "z-rev"), seed=0,
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
    a, b = _state_leaves(ref.final_state), _state_leaves(rev.final_state)
    assert len(a) == len(b) > 0
    assert all(torch.equal(x.detach(), y.detach()) for x, y in zip(a, b))
