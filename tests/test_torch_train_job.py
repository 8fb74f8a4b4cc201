"""The Kotta job path for training in the port, against the JAX package:
the tiered object store (``core/lifecycle.py``), the data pipeline, the
checkpointer, the elastic trainer and its launcher.

- the lifecycle copy follows the reference's tiers, migrations, restore
  times, errors and monthly cost on one scripted sequence;
- ``SyntheticCorpus`` writes the reference's bytes for the same seed, and
  ``TokenLoader`` gives the reference's batches for the same seed, steps
  and data-parallel ranks; prefetch matches direct;
- ``Checkpointer``: the reference's six cases (tests/test_checkpoint.py):
  bitwise roundtrip with bf16 and ``QTensor`` leaves, async save, latest
  and gc, corruption detected, archive aging with the restore queue;
- ``ElasticTrainer``: the loss falls; a revocation restart is bitwise equal
  to an uninterrupted run; the port's and the reference's trainers started
  from the same weights (``init_state``) on the same data give losses
  within 1e-4 over three steps (float32); a microbatched step agrees with
  a plain one;
- ``python -m repro_torch.launch.train --device cpu`` prints its summary.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.core import ObjectArchivedError as JArchived  # noqa: E402
from repro.core import ObjectStore as JStore  # noqa: E402
from repro.core import LifecyclePolicy as JPolicy  # noqa: E402
from repro.core import VirtualClock as JClock  # noqa: E402
from repro.data import SyntheticCorpus as JCorpus  # noqa: E402
from repro.data import TokenLoader as JLoader  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro.train import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import ElasticTrainer as JTrainer  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import (LifecyclePolicy, ObjectArchivedError,  # noqa: E402
                              ObjectStore, Tier, VirtualClock, days, hours)
from repro_torch.data import (PrefetchLoader, SyntheticCorpus,  # noqa: E402
                              TokenLoader)
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import params_from_reference  # noqa: E402
from repro_torch.train import (AdamWConfig, ElasticTrainer, adamw,  # noqa: E402
                               build_train_step)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, adamw.QTensor):
        return [tree.q, tree.scale]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def test_lifecycle_copy_follows_the_reference():
    policy = "STD30-IA60-ARCHIVE"
    stores = [(ObjectStore(clock=VirtualClock(),
                           policy=LifecyclePolicy.parse(policy)),
               ObjectArchivedError),
              (JStore(clock=JClock(), policy=JPolicy.parse(policy)),
               JArchived)]

    def state(store):
        return ([(k, store.head(k).tier.value, store.head(k).size_bytes)
                 for k in store.keys()],
                [(e.key, e.src.value, e.dst.value, e.reason)
                 for e in store.migrations],
                round(store.monthly_cost(), 12))

    script = [
        ("put", "dataset/wos/a", b"x" * 3_000_000, {}),
        ("put", "dataset/wos/b", b"y" * 1_000_000, {}),
        ("put", "hot", b"z" * 500_000, {"pinned": True}),
        ("put", "scratch", b"w" * 200, {"tier": "HOT"}),
        ("advance", days(29)), ("get", "dataset/wos/a"),
        ("advance", days(2)), ("tick",),
        ("advance", days(31)), ("tick",),
        ("advance", days(60)), ("tick",),
        ("get", "dataset/wos/b"), ("restore", "dataset/wos/b"),
        ("advance", hours(3.9)), ("get", "dataset/wos/b"),
        ("advance", hours(0.2)), ("get", "dataset/wos/b"), ("tick",),
        ("delete", "scratch"), ("advance", days(400)), ("tick",),
    ]
    trail = []
    for store, archived in stores:
        out = []
        for op, *args in script:
            if op == "put":
                key, data, kw = args
                if "tier" in kw:              # each package's own Tier
                    tier_cls = type(store.policy.stages[0].tier)
                    kw = dict(kw, tier=tier_cls[kw["tier"]])
                store.put(key, data, **kw)
            elif op == "advance":
                store.clock.advance(args[0])
            elif op == "tick":
                store.tick()
            elif op == "get":
                try:
                    out.append(("get", bytes(store.get(args[0]))[:4]))
                except archived as e:
                    out.append(("archived", e.restore_eta))
            elif op == "restore":
                out.append(("eta", store.restore(args[0])))
            elif op == "delete":
                store.delete(args[0])
            out.append(state(store))
        trail.append(out)
    assert trail[0] == trail[1]
    port = stores[0][0]
    assert port.head("hot").tier is Tier.STD          # pinned never ages
    assert port._blobs["dataset/wos/a"] != b"x" * 3_000_000  # at rest


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def _corpora():
    kw = dict(num_shards=2, tokens_per_shard=8192, vocab_size=101, seed=5)
    ps, js = ObjectStore(clock=VirtualClock()), JStore(clock=JClock())
    return (ps, SyntheticCorpus.build(ps, "c", **kw)), \
        (js, JCorpus.build(js, "c", **kw))


def test_corpus_and_batches_equal_the_reference():
    (ps, pk), (js, jk) = _corpora()
    assert pk == jk
    assert [bytes(ps.get(k)) for k in pk] == [js.get(k) for k in jk]
    for dp in (1, 2):
        for rank in range(dp):
            kw = dict(batch_size=8, seq_len=16, seed=3, dp_rank=rank,
                      dp_size=dp)
            pl, jl = TokenLoader(ps.get, pk, **kw), JLoader(js.get, jk, **kw)
            for step in (0, 1, 7, pl.windows_per_epoch // 8 + 1):
                a, b = pl.batch_at(step), jl.batch_at(step)
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_matches_direct():
    (ps, pk), _ = _corpora()
    loader = TokenLoader(ps.get, pk, batch_size=4, seq_len=16)
    pf = PrefetchLoader(loader, start_step=0, depth=2)
    try:
        for step in range(3):
            np.testing.assert_array_equal(next(pf)["tokens"],
                                          loader.batch_at(step)["tokens"])
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# checkpointer (the reference's tests/test_checkpoint.py cases)
# ---------------------------------------------------------------------------

def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"layers": {"w": torch.randn(8, 16, generator=g),
                       "b": torch.randn(16, generator=g)},
            "embed": torch.randn(32, 8, generator=g).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def test_checkpoint_roundtrip_bitwise():
    store = ObjectStore(clock=VirtualClock())
    ck = Checkpointer(store, "runA")
    tree = _tree(0)
    ck.save(3, tree)
    step, back = ck.restore(_zeros_like(tree))
    assert step == 3
    for a, b in zip(_leaves(tree), _leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


def test_checkpoint_roundtrip_with_qtensor_state():
    store = ObjectStore(clock=VirtualClock())
    ck = Checkpointer(store, "runQ")
    cfg = AdamWConfig(state_dtype="int8")
    params = {"w": torch.ones(64, 128)}
    state = adamw.init(cfg, params)
    grads = {"w": torch.randn(64, 128, generator=torch.Generator()
                              .manual_seed(1))}
    params, state, _ = adamw.update(cfg, grads, state, params)
    ck.save(1, (params, state))
    like = ({"w": torch.zeros(64, 128)}, adamw.init(cfg, params))
    _, (p2, s2) = ck.restore(like)
    assert isinstance(s2.m["w"], adamw.QTensor)
    assert s2.m["w"].shape == (64, 128)
    assert torch.equal(s2.m["w"].q, state.m["w"].q)
    assert torch.equal(s2.v["w"].scale, state.v["w"].scale)
    assert int(s2.step) == 1 and torch.equal(p2["w"], params["w"])


def test_checkpoint_async_save_then_restore():
    store = ObjectStore(clock=VirtualClock())
    ck = Checkpointer(store, "runB")
    tree = _tree(1)
    ck.save(1, tree, blocking=False)
    ck.wait()
    _, back = ck.restore(_zeros_like(tree))
    assert torch.equal(back["layers"]["w"], tree["layers"]["w"])


def test_checkpoint_latest_and_gc():
    store = ObjectStore(clock=VirtualClock())
    ck = Checkpointer(store, "runC", keep_last=2)
    tree = {"w": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    assert ck.steps() == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_corruption_detected_on_restore():
    store = ObjectStore(clock=VirtualClock())
    ck = Checkpointer(store, "runD")
    tree = {"w": torch.ones(4, 4)}
    ck.save(1, tree)
    key = [k for k in store.keys() if k.endswith(".npy")][0]
    blob = bytes(store.get(key))
    store.put(key, blob[:-4] + b"\x00\x00\x00\x01", owner="evil")
    with pytest.raises(IOError, match="checksum"):
        ck.restore(tree)


def test_checkpoints_age_into_archive_and_restore_queue():
    clock = VirtualClock()
    store = ObjectStore(clock=clock,
                        policy=LifecyclePolicy.parse("STD30-IA60-ARCHIVE"))
    ck = Checkpointer(store, "runE")
    tree = {"w": torch.ones(4)}
    ck.save(1, tree)
    clock.advance(days(120))
    store.tick()
    assert store.head(ck._manifest_key(1)).tier is Tier.ARCHIVE
    with pytest.raises(ObjectArchivedError):
        ck.restore(tree)
    for k in store.keys("checkpoints/runE/"):
        store.restore(k)
    clock.advance(4 * 3600 + 1)
    _, back = ck.restore(tree)
    assert torch.equal(back["w"], tree["w"])


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def env():
    cfg = get_reduced_config("internlm2-1.8b").replace(vocab_size=128)
    store = ObjectStore(clock=VirtualClock())
    keys = SyntheticCorpus.build(store, "t", num_shards=1,
                                 tokens_per_shard=8192,
                                 vocab_size=cfg.vocab_size)
    loader = TokenLoader(store.get, keys, batch_size=8, seq_len=32)
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=2, decay_steps=50)
    return cfg, store, loader, opt


def test_trainer_loss_decreases(env):
    cfg, store, loader, opt = env
    tr = ElasticTrainer(cfg, opt, Checkpointer(store, "t-base"), seed=0,
                        device="cpu")
    rep = tr.train(loader, 10, checkpoint_every=10)
    assert rep.losses[10] < rep.losses[1]
    assert rep.final_step == 10 and rep.restarts == 0
    assert all(p.dtype == torch.float32
               for p in _leaves(tr.final_state[0]))   # f32 master weights


def test_trainer_revocation_restart_bitwise_equal(env):
    cfg, store, loader, opt = env
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=2, decay_steps=50,
                      state_dtype="int8")
    t_ref = ElasticTrainer(cfg, opt, Checkpointer(store, "t-ref"), seed=0,
                           device="cpu")
    ref = t_ref.train(loader, 6, checkpoint_every=3)
    t_rev = ElasticTrainer(cfg, opt, Checkpointer(store, "t-rev"), seed=0,
                           device="cpu", async_checkpoint=True)
    fired = []

    def revoke(step):
        if step == 4 and not fired:
            fired.append(step)
            return True
        return False

    rev = t_rev.train(loader, 6, checkpoint_every=3, revoke_at=revoke)
    assert rev.restarts == 1 and rev.steps_run == 7
    assert ref.losses[6] == rev.losses[6]
    a, b = _leaves(t_ref.final_state), _leaves(t_rev.final_state)
    assert len(a) == len(b)
    assert all(torch.equal(x.detach(), y.detach()) for x, y in zip(a, b))
    assert t_rev.ckpt.steps() == [3, 6]


def test_trainer_matches_reference_trainer(env):
    """Both trainers from the reference's weights, f32 compute, 3 steps."""
    jcfg = jax_reduced("yi-6b").replace(vocab_size=128, dtype="float32")
    tcfg = get_reduced_config("yi-6b").replace(vocab_size=128,
                                               dtype="float32")
    kw = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=50)
    jstore = JStore(clock=JClock())
    jkeys = JCorpus.build(jstore, "t", num_shards=1, tokens_per_shard=8192,
                          vocab_size=128)
    jloader = JLoader(jstore.get, jkeys, batch_size=8, seq_len=32)
    jt = JTrainer(jcfg, JAdamWConfig(**kw), JCheckpointer(jstore, "j"),
                  seed=0)
    jrep = jt.train(jloader, 3, checkpoint_every=10)

    _, store, loader, _ = env
    jparams = jax_init(jax_family(jcfg).layout(jcfg), jax.random.PRNGKey(0),
                       "float32")

    class FromReference(ElasticTrainer):
        def init_state(self):
            params = params_from_reference(
                self.cfg, self.family.layout(self.cfg),
                jax.tree.map(np.asarray, jparams), device="cpu",
                dtype=self.cfg.pdtype)
            return params, adamw.init(self.opt_cfg, params)

    tt = FromReference(tcfg, AdamWConfig(**kw), Checkpointer(store, "p"),
                       seed=0, device="cpu")
    trep = tt.train(loader, 3, checkpoint_every=10)
    for step in (1, 2, 3):
        assert trep.losses[step] == pytest.approx(jrep.losses[step],
                                                  abs=1e-4)
    assert trep.losses[3] < trep.losses[1]


def test_microbatched_step_close_to_plain(env):
    """In f32, where only the order of the sums differs (in bf16 each
    microbatch's weight gradient is rounded to bf16 on its own)."""
    cfg, store, loader, opt = env
    cfg = cfg.replace(dtype="float32")
    tr = ElasticTrainer(cfg, opt, Checkpointer(store, "unused"), seed=0,
                        device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in loader.batch_at(0).items()}
    outs = []
    for n in (1, 2):
        params, state = tr.init_state()
        for p in _leaves(params):
            p.requires_grad_(True)
        params, state, metrics = build_train_step(cfg, opt, n)(params, state,
                                                                batch)
        outs.append((params, metrics))
    (p1, m1), (p2, m2) = outs
    assert float(m2["total_loss"]) == pytest.approx(float(m1["total_loss"]),
                                                    rel=1e-6)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-5)
    # a step moves a weight by up to lr (5e-4 here); an element whose
    # gradient is near 0 sees Adam's g / (|g| + eps) amplify the reordering
    for a, b in zip(_leaves(p1), _leaves(p2)):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-5,
                                   atol=1e-5)


def test_launcher_prints_summary(capsys):
    train_launch.main(["--arch", "internlm2-1.8b", "--steps", "4",
                       "--checkpoint-every", "2", "--batch", "4",
                       "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("internlm2-1.8b (reduced):")
    assert out[0].endswith("(cpu)")
    assert out[-1].startswith("steps=4 loss ")
    assert out[-1].endswith("checkpoints [2, 4]")
