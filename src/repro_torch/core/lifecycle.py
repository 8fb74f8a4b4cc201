"""Tiered object store with automated data-lifecycle management (paper §V-A).

Implements the paper's storage layer:

- Four tiers: ``HOT`` (instance-local / EBS-like staging space), ``STD``
  (S3-Standard), ``IA`` (S3-Infrequent-Access) and ``ARCHIVE`` (Glacier).
- An **LRU staleness lifecycle**: policies like ``STD30-IA60-ARCHIVE`` move an
  object down a tier when it has not been accessed for the stage's staleness
  window (paper Fig 2).
- **Archive semantics**: reading an ``ARCHIVE`` object fails fast with
  ``ObjectArchivedError``; callers request ``restore`` and the object becomes
  readable after the retrieval latency (4 h, paper Table III). The scheduler
  parks jobs on this signal (§V-A: "the job is placed in a separate queue
  until the data is available").
- **Server-side encryption at rest** (paper §VI): payloads are stored under a
  store-held key; ``get`` transparently decrypts.
- Cost accounting via :mod:`repro_torch.core.cost`, the price model the
  checkpointer's objects are charged by.

Checkpoints and datasets are written through this store, so old
checkpoints age HOT→STD→IA→ARCHIVE exactly like the paper's corpora age out
of S3.

A copy of the reference's ``repro/core/lifecycle.py`` with one change: the
at-rest cipher. The reference XORs a SHA-256 counter-mode keystream a byte
at a time in Python, some tens of seconds a GB; the port's checkpoints of a
full-width model are ~11 GB an object set, so it encrypts with AES-256 in
counter mode through OpenSSL's libcrypto (the library Python's ``hashlib``
already loads), at GB/s and with the GIL released, so the checkpointer's
writer threads run in parallel. The key is the same store-held key and the
nonce is still derived from the object's key; the ciphertext differs from
the reference's, which no caller reads. ``get`` returns a fresh
``bytearray``, which every caller uses as bytes, so a large object is not
copied once more.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import enum
import hashlib
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import cost as cost_mod
from .clock import Clock, days, hours


class _AesCtr:
    """AES-256-CTR from OpenSSL's libcrypto through ctypes (whose foreign
    calls release the GIL). Loaded once, at the first seal."""

    _lib = None
    CHUNK = 1 << 30              # EVP_EncryptUpdate takes an int length

    @classmethod
    def lib(cls):
        if cls._lib is None:
            import _hashlib  # noqa: F401  (loads the libcrypto hashlib uses)
            path = None
            try:
                with open("/proc/self/maps") as f:
                    path = next((ln.split()[-1] for ln in f
                                 if "libcrypto" in ln), None)
            except OSError:
                pass
            path = path or ctypes.util.find_library("crypto")
            if path is None:
                raise StorageError("at-rest encryption needs OpenSSL's "
                                   "libcrypto, which was not found")
            lib = ctypes.CDLL(path)
            P = ctypes.c_void_p
            lib.EVP_CIPHER_CTX_new.restype = P
            lib.EVP_CIPHER_CTX_free.argtypes = [P]
            lib.EVP_aes_256_ctr.restype = P
            lib.EVP_EncryptInit_ex.argtypes = [P, P, P, P, P]
            lib.EVP_EncryptUpdate.argtypes = [P, P, ctypes.POINTER(
                ctypes.c_int), P, ctypes.c_int]
            cls._lib = lib
        return cls._lib

    @classmethod
    def apply(cls, key: bytes, iv: bytes, data) -> bytearray:
        """Encrypt (or, the same, decrypt) ``data`` (any contiguous
        bytes-like object) into a new bytearray."""
        lib = cls.lib()
        src = np.frombuffer(data, dtype=np.uint8)
        out = bytearray(src.size)
        if not src.size:
            return out
        dst = np.frombuffer(out, dtype=np.uint8)
        ctx = lib.EVP_CIPHER_CTX_new()
        try:
            if not lib.EVP_EncryptInit_ex(ctx, lib.EVP_aes_256_ctr(), None,
                                          key, iv):
                raise StorageError("EVP_EncryptInit_ex failed")
            n = ctypes.c_int()
            for lo in range(0, src.size, cls.CHUNK):
                m = min(cls.CHUNK, src.size - lo)
                if not lib.EVP_EncryptUpdate(ctx, dst.ctypes.data + lo,
                                             ctypes.byref(n),
                                             src.ctypes.data + lo, m) \
                        or n.value != m:
                    raise StorageError("EVP_EncryptUpdate failed")
        finally:
            lib.EVP_CIPHER_CTX_free(ctx)
        return out


class Tier(enum.Enum):
    HOT = "HOT"          # instance-local staging (EBS/ephemeral; device or host memory)
    STD = "STD"          # S3-Standard
    IA = "IA"            # S3-Infrequent-Access
    ARCHIVE = "ARCHIVE"  # Glacier

    @property
    def immediate(self) -> bool:
        return self is not Tier.ARCHIVE


#: Order used by lifecycle demotion.
TIER_ORDER = (Tier.HOT, Tier.STD, Tier.IA, Tier.ARCHIVE)

RESTORE_LATENCY_S = hours(4)  # paper: average Glacier retrieval time


class StorageError(Exception):
    pass


class ObjectNotFoundError(StorageError):
    pass


class ObjectArchivedError(StorageError):
    """Raised when reading an object that must first be restored."""

    def __init__(self, key: str, restore_eta: Optional[float] = None):
        self.key = key
        self.restore_eta = restore_eta
        super().__init__(f"object {key!r} is archived (restore_eta={restore_eta})")


@dataclass
class LifecycleStage:
    tier: Tier
    staleness_s: Optional[float]  # None for the terminal stage


@dataclass(frozen=True)
class LifecyclePolicy:
    """Parsed form of e.g. ``"STD30-IA60-ARCHIVE"`` (paper §V-A).

    Stage ``STD30`` means: objects rest in STD and move to the next stage
    after 30 days without access.
    """

    stages: tuple[LifecycleStage, ...]

    @classmethod
    def parse(cls, text: str) -> "LifecyclePolicy":
        stages = []
        for part in text.split("-"):
            m = re.fullmatch(r"([A-Za-z]+)(\d*)", part)
            if not m:
                raise ValueError(f"bad lifecycle stage {part!r}")
            tier = Tier[m.group(1).upper().replace("GLACIER", "ARCHIVE")]
            staleness = days(int(m.group(2))) if m.group(2) else None
            stages.append(LifecycleStage(tier, staleness))
        if any(s.staleness_s is None for s in stages[:-1]):
            raise ValueError("only the terminal stage may omit staleness")
        return cls(tuple(stages))

    def stage_of(self, tier: Tier) -> Optional[int]:
        for i, s in enumerate(self.stages):
            if s.tier is tier:
                return i
        return None

    def next_tier(self, tier: Tier, idle_s: float) -> Tier:
        """Tier the object should occupy given time since last access."""
        i = self.stage_of(tier)
        if i is None:
            return tier
        while i < len(self.stages) - 1:
            staleness = self.stages[i].staleness_s
            if staleness is None or idle_s < staleness:
                break
            idle_s -= staleness
            i += 1
        return self.stages[i].tier


DEFAULT_POLICY = LifecyclePolicy.parse("STD30-IA60-ARCHIVE")


@dataclass
class ObjectMeta:
    key: str
    size_bytes: int
    tier: Tier
    owner: str
    created_at: float
    last_access: float
    checksum: str
    restore_ready_at: Optional[float] = None  # set while a restore is in flight
    pinned: bool = False                      # exempt from lifecycle demotion


@dataclass(frozen=True)
class MigrationEvent:
    timestamp: float
    key: str
    src: Tier
    dst: Tier
    reason: str  # "lifecycle" | "restore" | "stage"


class ObjectStore:
    """In-memory tiered object store with lifecycle + restore machinery.

    Payloads are held encrypted-at-rest; metadata drives lifecycle/cost.
    ``tick()`` runs the lifecycle daemon once (tests/simulations call it with
    a virtual clock; the service wires it to a background thread).
    """

    def __init__(self, clock: Clock | None = None,
                 policy: LifecyclePolicy = DEFAULT_POLICY,
                 pricing: cost_mod.StoragePricing | None = None,
                 encryption_key: bytes | None = None):
        self.clock = clock or Clock()
        self.policy = policy
        self.pricing = pricing or cost_mod.StoragePricing()
        self._key = encryption_key or hashlib.sha256(b"kotta-at-rest").digest()
        self._meta: dict[str, ObjectMeta] = {}
        self._blobs: dict[str, bytearray] = {}
        self.migrations: list[MigrationEvent] = []
        self._access_log: list[tuple[float, str, int]] = []  # (t, key, bytes)

    # -- encryption at rest ------------------------------------------------
    def _seal(self, key: str, data) -> bytearray:
        iv = hashlib.sha256(key.encode()).digest()[:16]
        return _AesCtr.apply(self._key, iv, data)

    _open = _seal  # a counter-mode stream cipher is symmetric

    # -- CRUD ----------------------------------------------------------------
    def put(self, key: str, data, owner: str = "system",
            tier: Tier = Tier.STD, pinned: bool = False) -> ObjectMeta:
        """Store ``data`` (any contiguous bytes-like object, e.g. a numpy
        array's buffer) under ``key``. Safe to call from several threads
        for different keys."""
        now = self.clock.now()
        view = memoryview(data).cast("B")
        meta = ObjectMeta(
            key=key, size_bytes=view.nbytes, tier=tier, owner=owner,
            created_at=now, last_access=now,
            checksum=hashlib.sha256(view).hexdigest(), pinned=pinned)
        self._meta[key] = meta
        self._blobs[key] = self._seal(key, view)
        return meta

    def head(self, key: str) -> ObjectMeta:
        meta = self._meta.get(key)
        if meta is None:
            raise ObjectNotFoundError(key)
        return meta

    def exists(self, key: str) -> bool:
        return key in self._meta

    def get(self, key: str) -> bytearray:
        """Read an object; bumps LRU recency; archived objects must restore."""
        meta = self.head(key)
        self._complete_restore(meta)
        if meta.tier is Tier.ARCHIVE:
            raise ObjectArchivedError(key, meta.restore_ready_at)
        now = self.clock.now()
        meta.last_access = now
        self._access_log.append((now, key, meta.size_bytes))
        data = self._open(key, self._blobs[key])
        if hashlib.sha256(data).hexdigest() != meta.checksum:
            raise StorageError(f"checksum mismatch for {key!r} (corruption)")
        return data

    def delete(self, key: str) -> None:
        self._meta.pop(key, None)
        self._blobs.pop(key, None)

    def keys(self, prefix: str = "") -> list[str]:
        return sorted(k for k in self._meta if k.startswith(prefix))

    # -- archive restore -------------------------------------------------------
    def restore(self, key: str) -> float:
        """Request retrieval of an archived object. Returns ready time."""
        meta = self.head(key)
        if meta.tier is not Tier.ARCHIVE:
            return self.clock.now()
        if meta.restore_ready_at is None:
            meta.restore_ready_at = self.clock.now() + RESTORE_LATENCY_S
        return meta.restore_ready_at

    def is_available(self, key: str) -> bool:
        meta = self.head(key)
        self._complete_restore(meta)
        return meta.tier.immediate

    def _complete_restore(self, meta: ObjectMeta) -> None:
        if (meta.tier is Tier.ARCHIVE and meta.restore_ready_at is not None
                and self.clock.now() >= meta.restore_ready_at):
            self._migrate(meta, Tier.STD, "restore")
            meta.restore_ready_at = None
            meta.last_access = self.clock.now()

    # -- lifecycle daemon ------------------------------------------------------
    def tick(self) -> list[MigrationEvent]:
        """Apply the LRU lifecycle policy once; returns migrations performed."""
        now = self.clock.now()
        out = []
        for meta in self._meta.values():
            self._complete_restore(meta)
            if meta.pinned:
                continue
            idle = now - meta.last_access
            target = self.policy.next_tier(meta.tier, idle)
            if target is not meta.tier:
                out.append(self._migrate(meta, target, "lifecycle"))
        return out

    def _migrate(self, meta: ObjectMeta, dst: Tier, reason: str) -> MigrationEvent:
        ev = MigrationEvent(self.clock.now(), meta.key, meta.tier, dst, reason)
        meta.tier = dst
        self.migrations.append(ev)
        return ev

    # -- accounting -------------------------------------------------------------
    def bytes_in_tier(self, tier: Tier) -> int:
        return sum(m.size_bytes for m in self._meta.values() if m.tier is tier)

    def monthly_cost(self) -> float:
        """Current $/month footprint across tiers (decimal GB, paper prices)."""
        gb = lambda b: b / 1e9
        return (
            cost_mod.s3_std_monthly(gb(self.bytes_in_tier(Tier.STD)), self.pricing)
            + cost_mod.s3_ia_monthly(gb(self.bytes_in_tier(Tier.IA)), self.pricing)
            + cost_mod.glacier_monthly(gb(self.bytes_in_tier(Tier.ARCHIVE)), self.pricing)
            + gb(self.bytes_in_tier(Tier.HOT)) * self.pricing.ebs_per_gb_month
        )

    def access_events(self) -> list[tuple[float, str, int]]:
        return list(self._access_log)


class SecureStorage:
    """Security-fabric wrapper: every access is authorized + audited (§VI).

    Resource naming convention: keys ARE resource names, e.g.
    ``dataset/wos/part-00001`` or ``results/<user>/<job>/out.txt``.
    """

    def __init__(self, store: ObjectStore, engine):
        self.store = store
        self.engine = engine

    def put(self, token, key: str, data: bytes, tier: Tier = Tier.STD,
            pinned: bool = False) -> ObjectMeta:
        self.engine.check(token, "data:Put", key)
        return self.store.put(key, data, owner=token.principal_id, tier=tier,
                              pinned=pinned)

    def get(self, token, key: str) -> bytes:
        """In-enclave read (analysis staging)."""
        self.engine.check(token, "data:Get", key)
        return self.store.get(key)

    def download(self, token, key: str) -> bytes:
        """Out-of-enclave read; private datasets carry an explicit deny."""
        self.engine.check(token, "data:Download", key)
        return self.store.get(key)

    def get_via_signed_url(self, url: str) -> bytes:
        key = self.engine.verify_url(url)
        return self.store.get(key)

    def list(self, token, prefix: str) -> list[str]:
        self.engine.check(token, "data:List", prefix + "*")
        return self.store.keys(prefix)
