"""Tiered, async, checksummed checkpointing through the lifecycle store.

A counterpart of the reference's ``repro/checkpoint/checkpointer.py``:
every leaf of (params, opt_state) is written as an object under
``checkpoints/<run>/<step>/...`` in the port's :class:`ObjectStore`, so old
checkpoints age HOT→STD→IA→ARCHIVE under the LRU lifecycle policy exactly
like the paper's corpora, and restoring an archived checkpoint goes through
the Glacier-restore path (``ObjectArchivedError``, then ``store.restore``).

Properties:
- sharded: one object per leaf; the leaves are written (and read) by a
  pool of threads, since the store's hashing and cipher release the GIL;
- checksummed: a manifest with a SHA-256 per leaf; the store hashes each
  leaf once as it stores it and checks it against that hash on every read,
  so restore compares the store's hash with the manifest's and detects a
  leaf that was replaced or corrupted;
- async: ``save(..., blocking=False)`` copies every leaf to host memory
  first and writes on a background thread (training continues); ``wait()``
  joins it;
- bit for bit: leaves are written from CPU copies of the tensors as raw
  bytes, bf16 as its 2-byte words, and ``restore(like)`` returns tensors of
  ``like``'s dtypes on ``like``'s devices.

Trees are nested dicts, tuples and lists (NamedTuples by field name), with
tensors and :class:`~repro_torch.train.adamw.QTensor` leaves.
"""
from __future__ import annotations

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from ..core.lifecycle import ObjectStore, Tier
from ..train.adamw import QTensor

_RAW = {torch.bfloat16: torch.int16}     # no numpy dtype: stored as words
# Writer and reader threads: the store hashes and encrypts with the GIL
# released, so a leaf a core.
THREADS = min(8, os.cpu_count() or 1)


def _flatten(tree, prefix=""):
    """[(name, tensor)] of every leaf, names "/"-joined keys and indices."""
    if isinstance(tree, torch.Tensor):
        return [(prefix or "root", tree)]
    if isinstance(tree, QTensor):
        return _flatten({"q": tree.q, "scale": tree.scale}, prefix)
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        raise TypeError(f"checkpoint leaf {prefix!r}: {type(tree)}")
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _unflatten(like, values: dict, prefix=""):
    """``like``'s structure with each leaf taken from ``values`` by name."""
    if isinstance(like, torch.Tensor):
        return values[prefix or "root"]
    if isinstance(like, QTensor):
        d = _unflatten({"q": like.q, "scale": like.scale}, values, prefix)
        return QTensor(d["q"], d["scale"], like.shape)

    def sub(k, v):
        return _unflatten(v, values, f"{prefix}/{k}" if prefix else str(k))

    if isinstance(like, dict):
        return {k: sub(k, v) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(sub(k, v) for k, v in zip(like._fields, like)))
    return type(like)(sub(i, v) for i, v in enumerate(like))


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous().cpu()
    return t.view(_RAW.get(t.dtype, t.dtype)).numpy()


class Checkpointer:
    def __init__(self, store: ObjectStore, run_name: str,
                 tier: Tier = Tier.STD, keep_last: Optional[int] = None):
        self.store = store
        self.run = run_name
        self.tier = tier
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self.saves = 0

    # -- keys ---------------------------------------------------------------
    def _prefix(self, step: int) -> str:
        return f"checkpoints/{self.run}/{step:08d}"

    def _manifest_key(self, step: int) -> str:
        return self._prefix(step) + "/MANIFEST.json"

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        # Snapshot to host memory synchronously; write (maybe) async.
        host = [(name, _dtype_name(t.dtype), _to_host(t))
                for name, t in _flatten(tree)]
        if blocking:
            self._write(step, host)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves) -> None:
        def put(leaf):
            name, dtype, arr = leaf
            key = f"{self._prefix(step)}/{name}.npy"
            meta = self.store.put(key, arr, owner=f"run:{self.run}",
                                  tier=self.tier)
            return {"name": name, "key": key, "shape": list(arr.shape),
                    "dtype": dtype, "sha256": meta.checksum}

        with ThreadPoolExecutor(THREADS) as pool:
            entries = list(pool.map(put, host_leaves))
        manifest = {"run": self.run, "step": step, "leaves": entries}
        self.store.put(self._manifest_key(step),
                       json.dumps(manifest).encode(),
                       owner=f"run:{self.run}", tier=self.tier)
        self.saves += 1
        if self.keep_last is not None:
            self._gc()

    # -- restore -------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for key in self.store.keys(f"checkpoints/{self.run}/"):
            if key.endswith("MANIFEST.json"):
                out.append(int(key.split("/")[-2]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None) -> tuple[int, Any]:
        """Restore into the structure of ``like``. Returns (step, tree).

        Raises ObjectArchivedError if the checkpoint has aged into ARCHIVE
        (callers then go through the restore queue, paper §V-A).
        """
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints for run {self.run!r}")
        manifest = json.loads(bytes(self.store.get(self._manifest_key(step))))
        by_name = {e["name"]: e for e in manifest["leaves"]}

        def load(leaf):
            name, want = leaf
            entry = by_name[name]
            data = self.store.get(entry["key"])   # checked against its hash
            if self.store.head(entry["key"]).checksum != entry["sha256"]:
                raise IOError(f"checksum mismatch restoring {name}")
            dt = getattr(torch, entry["dtype"])
            arr = np.frombuffer(data, dtype=torch.empty(
                0, dtype=_RAW.get(dt, dt)).numpy().dtype)
            arr = arr.reshape(entry["shape"])
            if list(arr.shape) != list(want.shape) or dt != want.dtype:
                raise ValueError(f"{name}: saved {entry['dtype']}"
                                 f"{tuple(arr.shape)} vs expected "
                                 f"{_dtype_name(want.dtype)}"
                                 f"{tuple(want.shape)}")
            return name, torch.from_numpy(arr).view(dt).to(want.device)

        with ThreadPoolExecutor(THREADS) as pool:
            values = dict(pool.map(load, _flatten(like)))
        return step, _unflatten(like, values)

    # -- gc ---------------------------------------------------------------------
    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep_last]:
            for key in self.store.keys(self._prefix(s)):
                self.store.delete(key)
