"""The port's batch runtime (``core/scheduler.py``: ``JobQueue``,
``Worker``, ``QueueWatcher``, ``KottaService``) against the reference's.

- The seven scenarios of tests/test_scheduler.py on the port, threads and
  all, each ending in a ``shutdown()`` that joins every thread the service
  started (the reference's own copies fail there: its ``Worker`` and
  ``QueueWatcher`` shadow ``Thread._stop``).
- Without threads, on a ``VirtualClock``: ``Worker._execute`` on unstarted
  workers and ``QueueWatcher.sweep`` called directly, in both packages, on
  the same scripted scenarios (park and unpark, staging denied, an
  executable that raises, ``JobCancelled`` on a revoked worker, a stale
  heartbeat, a straggler's speculative duplicate and the two completions)
  and ``JobQueue`` lease, expiry, ack and nack sequences. The db records
  (``JobStatus`` by value), the queues, the watcher's counters, the parked
  jobs, the staged-out objects and the audit log (by decision, principal,
  role, action, resource and time, never token strings) must be equal; job
  ids are mapped by submission order and worker names numbered afresh.
- The Cloud Kotta story at reduced size: a ``train_lm`` job over a private
  corpus, revoked through ``Worker.revoke()`` mid-run, resumed by a second
  worker from its checkpoint, its final state bit for bit equal to an
  uninterrupted ``ElasticTrainer`` run, its outputs and audit trail as in
  tests/test_system.py.
"""
import enum
import hashlib
import itertools
import threading
import time
from types import ModuleType, SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core.clock as j_clock  # noqa: E402
import repro.core.lifecycle as j_life  # noqa: E402
import repro.core.scheduler as j_sched  # noqa: E402
import repro.core.security as j_sec  # noqa: E402
import repro_torch.core.clock as t_clock  # noqa: E402
import repro_torch.core.lifecycle as t_life  # noqa: E402
import repro_torch.core.scheduler as t_sched  # noqa: E402
import repro_torch.core.security as t_sec  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint.checkpointer import _flatten  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import (AuthorizationError, ExecutableRegistry,  # noqa: E402
                              JobSpec, JobStatus, KottaService, ObjectStore,
                              PolicyEngine, Principal, Role, Tier,
                              VirtualClock, allow, install_standard_roles)
from repro_torch.data import SyntheticCorpus, TokenLoader  # noqa: E402
from repro_torch.train import AdamWConfig, ElasticTrainer  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _joined(svc):
    """Shut ``svc`` down and require every thread it started to be gone."""
    svc.shutdown()
    alive = [t.name for t in svc._threads if t.is_alive()]
    assert not alive, alive


# ---------------------------------------------------------------------------
# the reference's scheduler scenarios, threaded, on the port
# ---------------------------------------------------------------------------

def make_service(**watcher_kwargs):
    engine = PolicyEngine()
    install_standard_roles(engine)
    store = ObjectStore(clock=engine.clock)
    registry = ExecutableRegistry()

    @registry.register("wordcount")
    def wordcount(ctx):
        total = sum(len(bytes(v).split()) for v in ctx.staged_inputs.values())
        ctx.outputs[f"results/{ctx.job_id}/count.txt"] = str(total).encode()
        return total

    @registry.register("sleepy")
    def sleepy(ctx):
        for _ in range(50):
            ctx.checkpoint()
            time.sleep(0.01)
        return "done"

    @registry.register("boom")
    def boom(ctx):
        raise RuntimeError("analysis exploded")

    return KottaService(engine, store, registry,
                        watcher_kwargs=watcher_kwargs or
                        {"heartbeat_timeout_s": 0.5, "interval_s": 0.05})


def make_user(svc, uid="alice", dataset="corpus", assumers=("task-executor",)):
    role = Role(f"user-{uid}", policies=[
        allow(["data:Get", "data:List"], [f"dataset/{dataset}/*"]),
        allow(["data:*"], ["results/*"]),
        allow(["jobs:*"], ["queue/*"]),
    ], trusted_assumers=set(assumers))
    svc.engine.register_role(role)
    p = Principal(uid)
    svc.engine.authenticator.register_identity(p, "pw")
    svc.engine.bind(p, role.name)
    return svc.engine.login(uid, "pw")


@pytest.fixture
def svc():
    s = make_service()
    yield s
    _joined(s)


def test_end_to_end_job(svc):
    svc.store.put("dataset/corpus/a.txt", b"the quick brown fox", owner="sys")
    tok = make_user(svc)
    svc.start(dev_workers=1)
    job = svc.submit(tok, JobSpec("wordcount", inputs=("dataset/corpus/a.txt",),
                                  queue="dev"))
    rec = svc.wait(job, timeout_s=10)
    assert rec["status"] == JobStatus.COMPLETED
    assert svc.store.get(f"results/{job}/count.txt") == b"4"
    assert svc.store.head(f"results/{job}/count.txt").owner == "alice"


def test_unauthorized_submit_rejected(svc):
    svc.store.put("dataset/secret/a", b"x", owner="sys")
    tok = make_user(svc, dataset="corpus")
    svc.start()
    with pytest.raises(AuthorizationError):
        svc.submit(tok, JobSpec("wordcount", inputs=("dataset/secret/a",)))
    assert not svc.db.scan("job/")


def test_failed_job_reports_error(svc):
    tok = make_user(svc)
    svc.start()
    job = svc.submit(tok, JobSpec("boom", queue="dev"))
    rec = svc.wait(job, timeout_s=10)
    assert rec["status"] == JobStatus.FAILED
    assert "exploded" in rec["error"]


def test_archived_input_parks_then_runs(svc):
    svc.store.put("dataset/corpus/cold.txt", b"one two", owner="sys")
    meta = svc.store.head("dataset/corpus/cold.txt")
    meta.tier = Tier.ARCHIVE                    # aged into ARCHIVE
    tok = make_user(svc)
    svc.start(dev_workers=1)
    job = svc.submit(tok, JobSpec("wordcount",
                                  inputs=("dataset/corpus/cold.txt",),
                                  queue="dev"))
    time.sleep(0.3)
    assert svc.status(job)["status"] == JobStatus.WAITING_DATA
    meta.restore_ready_at = svc.clock.now() - 1   # the 4 h restore, done
    rec = svc.wait(job, timeout_s=10)
    assert rec["status"] == JobStatus.COMPLETED
    assert svc.store.get(f"results/{job}/count.txt") == b"2"


def test_revocation_resubmits_and_completes(svc):
    tok = make_user(svc)
    svc.start(dev_workers=1)
    w_spot = svc.add_worker("prod", preemptible=True)
    job = svc.submit(tok, JobSpec("sleepy", queue="prod"))
    deadline = time.time() + 5
    while (svc.status(job)["status"] != JobStatus.RUNNING
           and time.time() < deadline):
        time.sleep(0.02)
    w_spot.revoke()                      # spot reclaim mid-run
    w_new = svc.add_worker("prod", preemptible=True)
    rec = svc.wait(job, timeout_s=20)
    assert rec["status"] == JobStatus.COMPLETED
    assert rec["worker"] == w_new.name
    w_spot.join(timeout=5)
    assert not w_spot.is_alive() and w_spot not in svc.workers()


def test_worker_assumes_user_role_for_staging(svc):
    svc.store.put("dataset/corpus/a.txt", b"hello world", owner="sys")
    tok = make_user(svc)
    svc.start(dev_workers=1)
    job = svc.submit(tok, JobSpec("wordcount", inputs=("dataset/corpus/a.txt",),
                                  queue="dev"))
    svc.wait(job, timeout_s=10)
    assumes = [r for r in svc.engine.audit.records(decision="allow")
               if r.action == "sts:AssumeRole" and "user-alice" in r.resource]
    assert [(r.principal_id, r.role_name) for r in assumes] == [
        ("service:task-executor", "task-executor")]
    staged = [r for r in svc.engine.audit.records(
        resource_glob="dataset/corpus/a.txt") if r.action == "data:Get"]
    assert [(r.principal_id, r.role_name) for r in staged] == [
        ("alice", "user-alice"), ("service:task-executor", "user-alice")]


def test_throughput_multiple_jobs(svc):
    tok = make_user(svc)
    svc.start(dev_workers=2)

    @svc.registry.register("quick")
    def quick(ctx):
        return "ok"

    jobs = [svc.submit(tok, JobSpec("quick", queue="dev")) for _ in range(12)]
    for j in jobs:
        assert svc.wait(j, timeout_s=15)["status"] == JobStatus.COMPLETED
    assert sum(w.jobs_done for w in svc.workers("dev")) == 12


def test_shutdown_joins_every_thread():
    """The watcher, the live workers and a revoked one (which has left
    ``workers()``) are all joined; the reference's shutdown joins only the
    live workers, and its ``join`` raises."""
    s = make_service()
    tok = make_user(s)
    s.start(dev_workers=2, prod_workers=1)
    revoked = s.workers("prod")[0]
    revoked.revoke()
    s.add_worker("prod")
    job = s.submit(tok, JobSpec("boom", queue="prod"))
    assert s.wait(job, timeout_s=10)["status"] == JobStatus.FAILED
    threads = list(s._threads)
    assert len(threads) == 5 and s.watcher in threads
    _joined(s)
    assert not s.watcher.is_alive()
    assert not any(t.is_alive() for t in threads)


# ---------------------------------------------------------------------------
# threadless differential scenarios, port against reference
# ---------------------------------------------------------------------------

def _namespace(*mods):
    ns = SimpleNamespace()
    for mod in mods:
        for k, v in vars(mod).items():
            if not k.startswith("__") and not isinstance(v, ModuleType):
                setattr(ns, k, v)
    return ns


IMPLS = {"port": _namespace(t_clock, t_life, t_sec, t_sched),
         "reference": _namespace(j_clock, j_life, j_sec, j_sched)}


class _Script:
    """A service on a VirtualClock (capacity high enough that the db never
    waits on it), a user, the executor's session and unstarted workers."""

    def __init__(self, m, assumers=("task-executor",), **watcher_kwargs):
        self.m = m
        clock = m.VirtualClock(1000.0)
        engine = m.PolicyEngine(clock=clock)
        m.install_standard_roles(engine)
        db = m.StateStore(clock, read_capacity=1e9, write_capacity=1e9)
        self.svc = m.KottaService(
            engine, m.ObjectStore(clock=clock), m.ExecutableRegistry(),
            clock=clock, db=db, watcher_kwargs=watcher_kwargs)
        role = m.Role("user-alice", policies=[
            m.allow(["data:Get", "data:List"], ["dataset/corpus/*"]),
            m.allow(["data:*"], ["results/*"]),
            m.allow(["jobs:*"], ["queue/*"]),
        ], trusted_assumers=set(assumers))
        engine.register_role(role)
        alice = m.Principal("alice")
        engine.authenticator.register_identity(alice, "pw")
        engine.bind(alice, role.name)
        self.user = engine.login("alice", "pw")
        self.token = engine.service_session("task-executor")
        self.ids = []
        self.seen = []

    def worker(self, queue="dev"):
        return self.m.Worker(self.svc, queue, preemptible=queue == "prod")

    def submit(self, executable, queue="dev", inputs=()):
        job = self.svc.submit(self.user, self.m.JobSpec(
            executable, inputs=tuple(inputs), queue=queue))
        self.ids.append(job)
        return job

    def execute(self, worker, queue="dev"):
        q = self.svc.queues[queue]
        worker._execute(self.token, q, q.get())

    def _norm(self, x):
        if isinstance(x, enum.Enum):
            return x.value
        if isinstance(x, (bytes, bytearray)):
            return bytes(x)
        if isinstance(x, str):
            for i, job in enumerate(self.ids):
                x = x.replace(job, f"J{i}")
            return x
        if isinstance(x, (list, tuple)):
            return [self._norm(v) for v in x]
        if isinstance(x, dict):
            return {self._norm(k): self._norm(v) for k, v in x.items()}
        return x

    def observe(self, label):
        svc = self.svc
        store = svc.store
        self.seen.append(self._norm({
            "label": label,
            "db": svc.db.scan("job/"),
            "queues": {name: (list(q._ready), q._leased)
                       for name, q in svc.queues.items()},
            "parked": svc._parked,
            "watcher": (svc.watcher.resubmissions, svc.watcher.speculations),
            "results": {k: (store.get(k), store.head(k).owner,
                            store.head(k).tier)
                        for k in store.keys("results/")},
            "audit": [(r.decision, r.principal_id, r.role_name, r.action,
                       r.resource, r.timestamp)
                      for r in svc.engine.audit.records()],
        }))


def _wordcount(s):
    @s.svc.registry.register("wordcount")
    def wordcount(ctx):
        total = sum(len(bytes(v).split()) for v in ctx.staged_inputs.values())
        ctx.outputs[f"results/{ctx.job_id}/count.txt"] = str(total).encode()
        return total


def _park_and_unpark(m):
    """An archived input parks the job (WAITING_DATA, a restore requested);
    the watcher unparks it once the 4 h restore is done; then it runs."""
    s = _Script(m)
    _wordcount(s)
    key = "dataset/corpus/cold.txt"
    s.svc.store.put(key, b"one two three", owner="sys")
    s.svc.store.head(key).tier = m.Tier.ARCHIVE
    w = s.worker()
    s.submit("wordcount", inputs=[key])
    s.execute(w)
    s.observe("parked")
    s.svc.watcher.sweep()
    s.observe("still archived")
    s.svc.clock.advance(m.RESTORE_LATENCY_S)
    s.svc.watcher.sweep()
    s.observe("unparked")
    s.execute(w)
    s.observe("ran")
    return s.seen


def _stage_denied(m):
    """The user's role does not trust the executor: the assume-role is
    denied and audited, and the job fails without running."""
    s = _Script(m, assumers=())
    _wordcount(s)
    s.svc.store.put("dataset/corpus/a.txt", b"x y", owner="sys")
    s.submit("wordcount", inputs=["dataset/corpus/a.txt"])
    s.execute(s.worker())
    s.observe("denied")
    return s.seen


def _executable_raises(m):
    s = _Script(m)

    @s.svc.registry.register("boom")
    def boom(ctx):
        ctx.report(stage="about to fail")
        raise RuntimeError("analysis exploded")

    s.submit("boom")
    s.submit("missing")
    w = s.worker()
    s.execute(w)
    s.observe("raised")
    s.execute(w)
    s.observe("unknown executable")
    return s.seen


def _cancelled(m):
    """A spot worker revoked mid-run: the executable's next checkpoint
    raises JobCancelled, the job goes back to the queue's head, PENDING
    with its note; the revoked worker cancels it again at once; a second
    worker completes it."""
    s = _Script(m)
    calls = []

    @s.svc.registry.register("interruptible")
    def interruptible(ctx):
        calls.append(ctx.job_id)
        s.svc.clock.advance(2.0)
        if len(calls) == 1:
            first.revoke()
        ctx.checkpoint()
        ctx.outputs[f"results/{ctx.job_id}/out.bin"] = b"attempt %d" % len(calls)
        return len(calls)

    first, second = s.worker("prod"), s.worker("prod")
    s.submit("interruptible", queue="prod")
    s.submit("interruptible", queue="prod")
    s.execute(first, "prod")
    s.observe("revoked mid-run")
    s.execute(first, "prod")
    s.observe("revoked before the run")
    s.execute(second, "prod")
    s.execute(second, "prod")
    s.observe("completed elsewhere")
    assert first.jobs_done == 0 and second.jobs_done == 2
    return s.seen


def _stale_heartbeat(m):
    """A heartbeat older than the timeout: the watcher resubmits the job
    while its first run still goes on; that run completes it; the copy
    finds it COMPLETED and only acks (first completion wins)."""
    s = _Script(m, heartbeat_timeout_s=5.0)

    @s.svc.registry.register("silent")
    def silent(ctx):
        ctx.report(step=1)
        s.svc.clock.advance(6.0)
        s.svc.watcher.sweep()
        s.observe("resubmitted")
        ctx.outputs[f"results/{ctx.job_id}/out.bin"] = b"late"
        return "late"

    s.submit("silent")
    first, second = s.worker(), s.worker()
    s.execute(first)
    s.observe("completed by the first run")
    s.execute(second)
    s.observe("copy acked")
    return s.seen


def _straggler(m):
    """Two jobs of 10 s set the median; a third still running at 31 s gets
    one speculative duplicate, which completes first. The original's own
    completion then overwrites it: the worker writes STAGING_OUT before its
    first-completion check, so the check never sees COMPLETED (a reference
    fault the port keeps)."""
    s = _Script(m, heartbeat_timeout_s=5.0, straggler_factor=3.0)
    runs = []

    @s.svc.registry.register("quick")
    def quick(ctx):
        s.svc.clock.advance(10.0)
        return "quick"

    @s.svc.registry.register("slow")
    def slow(ctx):
        runs.append(ctx.job_id)
        if len(runs) > 1:
            ctx.outputs[f"results/{ctx.job_id}/out.bin"] = b"duplicate"
            return "duplicate"
        s.svc.clock.advance(31.0)
        ctx.report(step=1)
        s.svc.watcher.sweep()
        s.svc.watcher.sweep()
        s.observe("speculated once")
        s.execute(dup)
        s.observe("duplicate completed")
        ctx.outputs[f"results/{ctx.job_id}/out.bin"] = b"original"
        return "original"

    w, dup = s.worker(), s.worker()
    s.submit("quick")
    s.submit("quick")
    s.execute(w)
    s.execute(w)
    s.submit("slow")
    s.execute(w)
    s.observe("original finished")
    assert w.jobs_done == 3 and dup.jobs_done == 1
    return s.seen


def _queue_sequence(m):
    clock = m.VirtualClock(0.0)
    q = m.JobQueue("q", clock, visibility_timeout_s=10.0)
    ops = [("put", "a"), ("put", "b"), ("put", "c"), ("get",), ("get",),
           ("nack", "b"), ("depth",), ("get",), ("advance", 11.0), ("get",),
           ("ack", "a"), ("nack", "zzz"), ("ack", "zzz"), ("get",), ("get",),
           ("advance", 5.0), ("ack", "c"), ("put", "d"), ("get",),
           ("advance", 6.0), ("nack", "b"), ("get",), ("get",), ("depth",),
           ("advance", 30.0), ("get",), ("get",), ("get",), ("depth",)]
    seen = []
    for op, *arg in ops:
        if op == "advance":
            clock.advance(*arg)
            out = None
        else:
            out = getattr(q, op)(*arg)
        seen.append((op, arg, out, list(q._ready), dict(q._leased)))
    return seen


SCENARIOS = {"park_and_unpark": _park_and_unpark,
             "stage_denied": _stage_denied,
             "executable_raises": _executable_raises,
             "cancelled": _cancelled,
             "stale_heartbeat": _stale_heartbeat,
             "straggler": _straggler,
             "queue_sequence": _queue_sequence}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_threadless_scenario_equals_reference(name, monkeypatch):
    got = {}
    for impl, m in IMPLS.items():
        monkeypatch.setattr(m.Worker, "_ids", itertools.count())
        got[impl] = SCENARIOS[name](m)
    assert got["port"] == got["reference"]
    assert got["port"]                               # it observed something


def test_threadless_scenarios_reach_their_states(monkeypatch):
    """What the scenarios above compare holds what each set out to show."""
    m = IMPLS["port"]
    monkeypatch.setattr(m.Worker, "_ids", itertools.count())
    parked, archived, unparked, ran = _park_and_unpark(m)
    assert parked["db"]["job/J0"]["status"] == "waiting_data"
    assert parked["parked"] == {"J0": ["dataset/corpus/cold.txt"]}
    assert archived["parked"] == parked["parked"]
    assert unparked["db"]["job/J0"]["status"] == "pending"
    assert unparked["queues"]["dev"][0] == ["J0"]
    assert ran["results"]["results/J0/count.txt"] == [b"3", "alice", "STD"]
    (denied,) = _stage_denied(m)
    rec = denied["db"]["job/J0"]
    assert rec["status"] == "failed" and "staging denied" in rec["error"]
    assert ["deny", "service:task-executor", "task-executor",
            "sts:AssumeRole", "role/user-alice"] in [
                a[:5] for a in denied["audit"]]
    raised, unknown = _executable_raises(m)
    assert raised["db"]["job/J0"]["error"] == \
        "RuntimeError('analysis exploded')"
    assert unknown["db"]["job/J1"]["status"] == "failed"
    mid, before, done = _cancelled(m)
    assert mid["db"]["job/J0"]["note"] == "revoked mid-run"
    assert mid["queues"]["prod"][0] == ["J0", "J1"]
    assert before["queues"]["prod"][0] == ["J0", "J1"]
    assert {done["db"][f"job/J{i}"]["status"] for i in (0, 1)} == {
        "completed"}
    resub, first, acked = _stale_heartbeat(m)
    assert resub["watcher"] == [1, 0] and resub["db"]["job/J0"]["attempt"] == 1
    assert first["db"]["job/J0"]["status"] == "completed"
    assert acked["queues"]["dev"] == [[], {}]
    monkeypatch.setattr(m.Worker, "_ids", itertools.count())
    spec, dup_done, orig = _straggler(m)
    assert spec["watcher"] == [0, 1] and spec["db"]["job/J2"]["speculated"]
    assert dup_done["db"]["job/J2"]["worker"] == "worker-1"
    assert orig["db"]["job/J2"]["worker"] == "worker-0"      # overwritten
    assert orig["results"]["results/J2/out.bin"][0] == b"original"


# ---------------------------------------------------------------------------
# the full story at reduced size: a revoked training job
# ---------------------------------------------------------------------------

STEPS, EVERY, REVOKE = 6, 3, 4


def _digest(state) -> str:
    h = hashlib.sha256()
    for name, t in _flatten(state):
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def test_revoked_training_job_resumes_bit_for_bit():
    cfg = get_reduced_config("internlm2-1.8b").replace(vocab_size=128)
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=2, decay_steps=50)
    corpus = dict(num_shards=2, tokens_per_shard=8192,
                  vocab_size=cfg.vocab_size)

    # The uninterrupted run the job is held to.
    plain_store = ObjectStore(clock=VirtualClock())
    plain = ElasticTrainer(cfg, opt, Checkpointer(plain_store, "plain"),
                           seed=0, device="cpu")
    plain_rep = plain.train(
        TokenLoader(plain_store.get, SyntheticCorpus.build(
            plain_store, "wos", **corpus), batch_size=4, seq_len=32),
        STEPS, checkpoint_every=EVERY)

    engine = PolicyEngine()
    install_standard_roles(engine)
    store = ObjectStore(clock=engine.clock)
    registry = ExecutableRegistry()
    svc = KottaService(engine, store, registry,
                       watcher_kwargs={"heartbeat_timeout_s": 60.0,
                                       "interval_s": 0.05,
                                       "speculation": False})
    shards = tuple(SyntheticCorpus.build(store, "wos", **corpus))
    attempts = []

    @registry.register("train_lm")
    def train_lm(ctx):
        worker = threading.current_thread()
        attempts.append(worker)
        loader = TokenLoader(lambda k: ctx.staged_inputs[k],
                             sorted(ctx.staged_inputs), batch_size=4,
                             seq_len=32)
        trainer = ElasticTrainer(cfg, opt,
                                 Checkpointer(store, f"job-{ctx.job_id}"),
                                 seed=0, device="cpu")
        step_fn, at = trainer._step_fn, [0]

        def step(params, opt_state, batch):
            out = step_fn(params, opt_state, batch)
            ctx.report(step=at[0] + 1, loss=float(out[2]["total_loss"]))
            return out

        def revoke_at(step):
            at[0] = step
            if step == REVOKE and len(attempts) == 1:
                worker.revoke()                  # the spot reclaim
                svc.add_worker("prod")           # its replacement
            ctx.checkpoint()
            return False

        trainer._step_fn = step
        rep = trainer.train(loader, STEPS, checkpoint_every=EVERY,
                            revoke_at=revoke_at)
        ctx.outputs[f"results/{ctx.job_id}/losses.npy"] = np.asarray(
            [rep.losses[s] for s in sorted(rep.losses)]).tobytes()
        ctx.outputs[f"results/{ctx.job_id}/state.sha256"] = _digest(
            trainer.final_state).encode()
        return {"first_step": min(rep.losses), "steps_run": rep.steps_run}

    engine.register_role(Role("researcher", policies=[
        allow(["data:Get", "data:List"], ["dataset/wos/*"]),
        allow(["data:*"], ["results/*"]),
        allow(["jobs:*"], ["queue/*"]),
    ], trusted_assumers={"task-executor"}))
    engine.register_role(Role("outsider", policies=[
        allow(["jobs:*"], ["queue/*"])]))
    for uid, role in (("alice", "researcher"), ("mallory", "outsider")):
        engine.authenticator.register_identity(Principal(uid), "pw")
        engine.bind(Principal(uid), role)

    svc.start(dev_workers=1, prod_workers=1)
    try:
        with pytest.raises(AuthorizationError):
            svc.submit(engine.login("mallory", "pw"),
                       JobSpec("train_lm", inputs=shards, queue="prod"))
        job = svc.submit(engine.login("alice", "pw"),
                         JobSpec("train_lm", inputs=shards, queue="prod"))
        rec = svc.wait(job, timeout_s=120, poll_s=0.05)
    finally:
        _joined(svc)

    assert rec["status"] == JobStatus.COMPLETED, rec
    assert rec["note"] == "revoked mid-run"
    assert rec["result"] == "{'first_step': 4, 'steps_run': 3}"
    revoked, finisher = attempts
    assert revoked.preemptible and revoked._revoked.is_set()
    assert rec["worker"] == finisher.name != revoked.name
    assert svc.watcher.resubmissions == 0 and svc.watcher.speculations == 0

    digest = svc.store.get(f"results/{job}/state.sha256").decode()
    assert digest == _digest(plain.final_state)
    losses = np.frombuffer(svc.store.get(f"results/{job}/losses.npy"))
    assert losses.tolist() == [plain_rep.losses[s] for s in (4, 5, 6)]
    for key in svc.store.keys(f"results/{job}/"):
        assert svc.store.head(key).owner == "alice"
    assert svc.store.keys(f"checkpoints/job-{job}/")

    audit = engine.audit.records()
    denied = [r for r in audit if r.principal_id == "mallory"]
    assert denied and denied[-1].decision == "deny"
    assumes = [r for r in audit if r.action == "sts:AssumeRole"]
    assert [(r.decision, r.principal_id, r.resource) for r in assumes] == [
        ("allow", "service:task-executor", "role/researcher")] * 2
    for shard in shards:
        reads = [(r.principal_id, r.role_name) for r in audit
                 if r.action == "data:Get" and r.resource == shard
                 and r.decision == "allow"]
        assert reads == [("alice", "researcher")] + [
            ("service:task-executor", "researcher")] * 2
