"""The Cloud Kotta story (paper §II + §VI): secure multi-tenant analytics
(the reference's ``examples/secure_analytics.py``).

Three tenants, one enclave:
- admin registers the private "wos" corpus (non-downloadable) + public wiki;
- alice (researcher, WOS access) submits an LDA-ish topic-count job: the
  worker assumes her role to stage data, counts on the example's device,
  near the data, and her results are private;
- bob (public-only) can analyze wikipedia but is denied WOS, at submit
  time, with the denial in the audit log;
- a cold shard ages to ARCHIVE; a job needing it parks in the restore queue
  (fast-forwarded here) and then completes: the paper's Glacier path.

    PYTHONPATH=src python -m repro_torch.examples.secure_analytics
        [--device cpu] [--tokens 4096]

Unlike the reference's, it ends with a clean ``shutdown``: the port's
threads stop on ``_halt`` and every one is joined.
"""
import argparse
import time

import numpy as np
import torch

from ..core import (AuthorizationError, ExecutableRegistry, JobSpec,
                    KottaService, ObjectStore, PolicyEngine, Principal, Role,
                    Tier, allow, install_standard_roles, make_dataset_role)
from ..device import resolve_device

TOPICS = 97          # token id -> topic bucket, id % 97
TOP = 5


def topic_counts(shards, device) -> list[tuple[int, int]]:
    """The ``TOP`` (topic, count) pairs across int32 token shards (bytes),
    most frequent first and ties by topic: one-hot sums on ``device``."""
    topics = torch.arange(TOPICS, device=device)
    counts = torch.zeros(TOPICS, dtype=torch.int64, device=device)
    for data in shards:
        ids = torch.from_numpy(np.frombuffer(data, dtype=np.int32).copy())
        ids = ids.to(device).long() % TOPICS
        counts += (ids[:, None] == topics[None]).sum(0)
    order = torch.sort(counts, descending=True, stable=True).indices[:TOP]
    return [(int(t), int(counts[t])) for t in order.tolist()]


def main(device="cuda", tokens: int = 4096) -> dict:
    dev = resolve_device(device)
    engine = PolicyEngine()
    install_standard_roles(engine)
    store = ObjectStore(clock=engine.clock)
    registry = ExecutableRegistry()

    @registry.register("topic_count")
    def topic_count(ctx):
        """Toy LDA stand-in: top topics across the staged shards."""
        top = topic_counts(ctx.staged_inputs.values(), dev)
        ctx.outputs[f"results/{ctx.job_id}/topics.txt"] = repr(top).encode()
        return top[0]

    svc = KottaService(engine, store, registry,
                       watcher_kwargs={"heartbeat_timeout_s": 2.0,
                                       "interval_s": 0.05})

    # --- datasets -----------------------------------------------------------
    rng = np.random.default_rng(0)
    for name, public in [("wos", False), ("wikipedia", True)]:
        prefix = "public/" if public else ""
        for i in range(2):
            store.put(f"dataset/{prefix}{name}/shard-{i}",
                      rng.integers(0, 50_000, tokens, dtype=np.int32).tobytes(),
                      owner="admin")
    make_dataset_role(engine, "wos", downloadable=False)

    # --- tenants ---------------------------------------------------------------
    researcher = Role("researcher", policies=[
        allow(["data:Get", "data:List"], ["dataset/wos/*", "dataset/public/*"]),
        allow(["data:*"], ["results/*"]),
        allow(["jobs:*"], ["queue/*"])], trusted_assumers={"task-executor"})
    publicuser = Role("public-user", policies=[
        allow(["data:Get", "data:List"], ["dataset/public/*"]),
        allow(["data:*"], ["results/*"]),
        allow(["jobs:*"], ["queue/*"])], trusted_assumers={"task-executor"})
    engine.register_role(researcher)
    engine.register_role(publicuser)
    for uid, role in [("alice", "researcher"), ("bob", "public-user")]:
        p = Principal(uid)
        engine.authenticator.register_identity(p, "pw")
        engine.bind(p, role)

    out = {"store": store}
    svc.start(dev_workers=1)
    try:
        alice = engine.login("alice", "pw")
        bob = engine.login("bob", "pw")

        # --- alice analyzes the private corpus ------------------------------
        wos = tuple(store.keys("dataset/wos/"))
        job = svc.submit(alice, JobSpec("topic_count", inputs=wos,
                                        queue="dev"))
        rec = svc.wait(job, timeout_s=30)
        topics = store.get(f"results/{job}/topics.txt").decode()
        print(f"[alice] WOS job {rec['status']}: {topics}")
        out["alice"] = (rec["status"], wos, topics)

        # --- bob is denied the private corpus --------------------------------
        try:
            svc.submit(bob, JobSpec("topic_count",
                                    inputs=("dataset/wos/shard-0",),
                                    queue="dev"))
            raise AssertionError("bob should have been denied")
        except AuthorizationError as e:
            print(f"[bob]   denied WOS as expected: {type(e).__name__}")
        job = svc.submit(bob, JobSpec(
            "topic_count",
            inputs=tuple(store.keys("dataset/public/wikipedia/")),
            queue="dev"))
        out["bob"] = svc.wait(job, timeout_s=30)["status"]
        print(f"[bob]   wikipedia job {out['bob']}")

        # --- the Glacier path ---------------------------------------------------
        cold = store.head("dataset/wos/shard-1")
        cold.tier = Tier.ARCHIVE
        job = svc.submit(alice, JobSpec(
            "topic_count", inputs=("dataset/wos/shard-1",), queue="dev"))
        time.sleep(0.4)
        parked = svc.status(job)["status"]
        print(f"[alice] cold-data job parked: {parked}")
        cold.restore_ready_at = engine.clock.now() - 1  # fast-forward 4h
        restored = svc.wait(job, timeout_s=30)["status"]
        print(f"[alice] after restore: {restored}")
        out["cold"] = (parked, restored)

        # --- audit --------------------------------------------------------------
        denials = engine.audit.records(decision="deny")
        print(f"audit: {len(engine.audit)} records, {len(denials)} denials "
              f"(e.g. {denials[-1].principal_id} -> {denials[-1].resource})")
        out["denials"] = denials
    finally:
        svc.shutdown()
    out["threads_alive"] = [t.name for t in svc._threads if t.is_alive()]
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--tokens", type=int, default=4096,
                    help="int32 tokens a shard")
    main(**vars(ap.parse_args()))
