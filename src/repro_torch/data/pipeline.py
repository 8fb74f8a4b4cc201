"""Data pipeline: corpus registration, sharded deterministic loading, staging.

Mirrors the paper's data path: corpora live in the tiered object store under
``dataset/<name>/shard-NNN`` with RBAC on the ``dataset/...`` resource names;
jobs *stage* shards (via ``SecureStorage.get``, i.e. under the submitting
user's assumed role) before compute touches them; archived shards trigger the
restore queue.

Determinism contract: ``TokenLoader.batch_at(step)`` is a pure function of
(corpus bytes, seed, dp_rank, dp_size, step) — this is what makes
checkpoint-restart *bitwise* reproducible and elastic rescales well-defined
(tested in tests/test_torch_train_job.py).

A copy of the reference's ``repro/data/pipeline.py``, numpy only: the same
seed gives the reference's corpus bytes and batches, and the trainer turns
a batch into tensors on its device.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

from ..core.lifecycle import ObjectStore, Tier


class SyntheticCorpus:
    """Deterministic synthetic token corpus registered in the object store."""

    @staticmethod
    def build(store: ObjectStore, name: str, *, num_shards: int = 4,
              tokens_per_shard: int = 65_536, vocab_size: int = 50_304,
              seed: int = 0, owner: str = "system",
              tier: Tier = Tier.STD) -> list[str]:
        keys = []
        for i in range(num_shards):
            rng = np.random.default_rng((seed, i))
            # Zipf-ish marginals so the loss has structure to learn.
            ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
            probs = 1.0 / ranks
            probs /= probs.sum()
            toks = rng.choice(vocab_size, size=tokens_per_shard,
                              p=probs).astype(np.int32)
            key = f"dataset/{name}/shard-{i:03d}"
            store.put(key, toks.tobytes(), owner=owner, tier=tier)
            keys.append(key)
        return keys


class TokenLoader:
    """Sharded, deterministic, step-indexed next-token-prediction loader.

    ``reader`` is any ``key -> bytes`` callable — typically
    ``lambda k: secure_storage.get(user_token, k)`` so every read is
    authorized + audited, or ``store.get`` for internal runs.
    """

    def __init__(self, reader: Callable[[str], bytes], keys: list[str],
                 *, batch_size: int, seq_len: int,
                 dp_rank: int = 0, dp_size: int = 1, seed: int = 0):
        if batch_size % dp_size:
            raise ValueError(f"global batch {batch_size} % dp {dp_size} != 0")
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.seed = seed
        # Stage all shards once (the worker has already assumed the user role).
        chunks = [np.frombuffer(reader(k), dtype=np.int32) for k in sorted(keys)]
        self._tokens = np.concatenate(chunks)
        self._window = seq_len + 1
        self.num_windows = len(self._tokens) // self._window
        if self.num_windows < batch_size:
            raise ValueError("corpus too small for one global batch")
        self.windows_per_epoch = (self.num_windows // batch_size) * batch_size
        self._perm_cache: dict[int, np.ndarray] = {}

    def _perm(self, epoch: int) -> np.ndarray:
        if epoch not in self._perm_cache:
            rng = np.random.default_rng((self.seed, epoch))
            self._perm_cache[epoch] = rng.permutation(self.num_windows)
            if len(self._perm_cache) > 4:
                self._perm_cache.pop(min(self._perm_cache))
        return self._perm_cache[epoch]

    def batch_at(self, step: int) -> dict:
        """This rank's slice of global batch ``step`` (pure function)."""
        steps_per_epoch = self.windows_per_epoch // self.batch_size
        epoch, within = divmod(step, steps_per_epoch)
        perm = self._perm(epoch)
        lo = within * self.batch_size
        idx = perm[lo:lo + self.batch_size]
        local = idx[self.dp_rank::self.dp_size]
        rows = np.stack([
            self._tokens[i * self._window:(i + 1) * self._window]
            for i in local])
        return {"tokens": rows[:, :-1].copy(), "labels": rows[:, 1:].copy()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchLoader:
    """Background-thread prefetch wrapper (overlap host data with compute)."""

    def __init__(self, loader: TokenLoader, start_step: int = 0, depth: int = 2):
        self.loader = loader
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put(self.loader.batch_at(step), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        return self._q.get()

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
