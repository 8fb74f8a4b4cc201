"""Continuous-batching serve engine over a shared block-paged KV cache.

The PyTorch port of the reference engine's token loop:

- **Slots and pages.** ``max_decode_slots`` batch lanes decode in lockstep;
  each request addresses its logical KV stream through a page-table row
  into one shared pool of ``page_size``-row pages. Physical page 0 is a
  reserved write sink: idle slots keep an all-zero page-table row, and
  prefill pads and budget overshoot route their KV writes there.
- **Paged chunked prefill.** Prompts are admitted in fixed
  ``prefill_chunk``-token steps whose KV rows land straight in pool pages.
  ``prefill_mode="dense"`` admits instead by one ragged dense prefill per
  pad bucket (prompt length rounded up to whole pages), whose cache is
  re-laid into the request's pages; it takes neither the prefix cache nor
  an int8 pool, as in the reference.
- **Copy-on-write prefix sharing.** A page-granular radix index
  (:mod:`repro_torch.serve.paging`) aliases fully matched pages
  (refcount++), copies the one partially matched boundary page, and
  prefills only the unmatched suffix.
- **Decode chunks without host syncs.** A decode chunk is a Python loop of
  exactly ``decode_chunk`` device steps; tokens accumulate on the device and
  cross to the host once per chunk. The pool is updated in place (the
  reference donates it to each chunk instead).
- **Speculative decode** (``enable_spec_decode``): each step drafts
  ``spec_tokens`` tokens per slot by n-gram lookup over the slot's history
  and verifies all of them plus the current token in one multi-query pass;
  per-slot adaptive windows (``spec_adaptive_k``) shrink the verify pass for
  slots that accept little. Greedy outputs equal plain decode's.
- **int8 KV pages** (``kv_cache_dtype="int8"``): per-row symmetric int8 with
  f32 scale pages, quantized on scatter and dequantized in the kernels.

The stepped API (``enqueue`` / ``admit`` / ``decode_step`` / ``abort``) is
what a control plane drives; ``generate`` is a loop over it. On top of it
sits the residency surface the control plane moves requests with:

- **Preemption** (``preempt`` / ``resume``): a request pauses mid-stream at
  a chunk boundary with its pages pinned (refcounts untouched) and its
  slot state parked host-side in a :class:`PausedRequest`; ``resume``
  re-attaches the pages to a free slot with zero re-prefill.
- **Page export** (``export(slot=|rid=, reason=)``): a live or paused
  request's content pages, the ``ceil(pos / page_size)`` pages holding KV
  rows, are gathered off the device into a :class:`ShippedKV` of CPU
  tensors in the pool's own dtype (bf16 at full width, so a page is half
  the reference's f32 bytes). ``import_pages`` revives a payload as a live
  request on another engine; ``restore_pages`` lands it as free-but-
  hittable prefix-cache pages. ``demote_on_retire`` exports every finished
  request before its pages are released, for a tiered store
  (:mod:`repro_torch.serve.kv_store`) to drain from ``demoted_out``.
- **Telemetry** (``bind_registry``): ``stats`` becomes a write-through view
  over :class:`~repro_torch.serve.telemetry.MetricsRegistry` counters.

``ServeEngine`` is the reference's static-batch engine: one left-padded
batch, a dense per-request cache, greedy decode. It serves every family:
the dense transformer (with or without experts), and the Zamba2 hybrid
and xLSTM, which have no paged path.
"""
from __future__ import annotations

import enum
import math
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..models import get_family
from ..train.train_step import (build_decode_step, build_fused_spec_step,
                                build_paged_decode_step,
                                build_paged_prefill_step,
                                build_prefill_ragged_step, build_prefill_step)
from .drafting import build_ngram_draft
from .paging import PageAllocator, PrefixCache
from .telemetry import RegistryDict


@dataclass
class ServeResult:
    tokens: np.ndarray          # (B, max_new)
    prompt_lens: list[int]


class ServeEngine:
    """Static-batch engine: left-pads the batch, dense per-request cache.

    ``generate`` left-pads every prompt with token 0 to the longest, so the
    newest token of each sits in the last column, prefills the batch at
    positions 0..S-1 (the pads enter the recurrent state and attention, as
    in the reference), grows the attention caches to ``max_len`` rows and
    decodes greedily ``max_new`` times: the last decode's token is never
    read, as in the reference. Tokens accumulate on the device and cross to
    the host once, at the end.

    Only the leaves the family names in ``grown_cache_leaves`` grow, along
    axis 2: ``k``/``v`` for the dense transformer, ``attn_k``/``attn_v``
    for Zamba2, none for xLSTM. The reference grows every cache leaf whose
    axis 2 equals the prompt length, which also catches a Mamba2 or xLSTM
    state or conv tail whose head count or window happens to equal it
    (ROADMAP.md, Queue 3).
    """

    def __init__(self, cfg, params, *, max_len: int = 512, device="cuda"):
        if cfg.encoder_only:
            raise ValueError("encoder-only models cannot decode")
        self.device = resolve_device(device)
        leaf = params["embedding"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the engine on "
                             f"{self.device}: build them on the same device")
        self.family = get_family(cfg)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self._prefill = build_prefill_step(cfg)
        self._decode = build_decode_step(cfg)

    def _pad_cache(self, cache, cur_len: int):
        """Grow the family's sequence leaves to ``max_len`` rows along axis
        2."""
        for name in self.family.grown_cache_leaves:
            if name in cache:
                x = cache[name]
                pad = x.new_zeros(x.shape[:2] + (self.max_len - cur_len,)
                                  + x.shape[3:])
                cache[name] = torch.cat([x, pad], dim=2)
        return cache

    def generate(self, prompts: list[list[int]],
                 max_new: int = 16) -> ServeResult:
        b = len(prompts)
        plen = max(len(p) for p in prompts)
        if plen > self.max_len:
            raise ValueError(f"prompt length {plen} exceeds max_len "
                             f"{self.max_len}")
        toks = np.zeros((b, plen), np.int64)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p  # left-pad so last position is newest
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        logits, cache = self._prefill(self.params, batch)
        cache = self._pad_cache(cache, plen)
        pos = torch.full((b,), plen - 1, dtype=torch.int32,
                         device=self.device)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = torch.zeros((b, max_new), dtype=torch.int32,
                          device=self.device)
        for t in range(max_new):
            out[:, t] = next_tok
            pos = pos + 1
            step_batch = {"tokens": next_tok[:, None], "pos": pos}
            next_tok, _, cache = self._decode(self.params, step_batch, cache)
        return ServeResult(out.cpu().numpy(), [len(p) for p in prompts])


@dataclass
class EngineRequest:
    """One generation request: ``rid`` is caller-chosen, ``max_new`` is per
    request, and ``namespace`` scopes the prefix cache (pages registered
    under one namespace are invisible to lookups from another)."""
    rid: object
    prompt: list[int]
    max_new: int
    namespace: object = None


@dataclass
class _Live:
    """A request occupying a slot."""
    req: EngineRequest
    pages: list[int]
    emitted: int = 0
    tokens: list[int] = field(default_factory=list)


@dataclass
class PausedRequest:
    """A preempted request parked host-side, its KV pages still pinned.

    ``pages`` keep their refcounts, so the allocator can never hand them
    out while the request is paused; ``cur``/``pos``/``limit`` and, under
    speculative decode, ``hist`` (the first ``hist_len`` columns of the
    slot's drafting-history row, int32) plus the adaptive window and
    accept-rate EMA are the slot state at the chunk boundary where it was
    paused. ``resume`` restores all of it with zero re-prefill.
    """
    req: EngineRequest
    pages: list[int]
    emitted: int
    tokens: list[int]
    cur: int
    pos: int
    limit: int
    hist: np.ndarray | None = None
    kslot: int = 0
    ema: float = 0.0


class CapacityError(RuntimeError):
    """The engine refuses a request for want of room: no free slot, or not
    enough free pages in the pool. The control plane takes it as "try
    another replica"; every other ``RuntimeError`` (a failed kernel launch,
    a CUDA fault, an out-of-memory in the scatter) is a device failure and
    propagates. A subclass, so ``except RuntimeError`` still catches it."""


class ExportReason(str, enum.Enum):
    """Why a request's pages leave the device pool: a disaggregated
    prefill -> decode hop (``HANDOFF``), a revocation-notice migration
    (``EVACUATE``) or a tier demotion into a tiered KV store (``DEMOTE``).
    The gather is the same for all three."""

    HANDOFF = "handoff"
    EVACUATE = "evacuate"
    DEMOTE = "demote"


@dataclass
class ShippedKV:
    """A request's KV pages in flight between engines or tiers.

    ``content`` maps every pool leaf name to a ``(L, KV, n_content,
    page_size[, hd])`` CPU tensor in the pool's dtype: ``k``/``v`` in
    ``cfg.dtype`` (bf16 at full width; numpy has no bf16, hence tensors),
    plus the f32 ``k_scale``/``v_scale`` pages of an int8 pool. Sizes come
    from ``numel() * element_size()``, so a bf16 page is half the bytes of
    the reference's f32 one. ``tokens``/``emitted``/``cur``/``pos`` (and
    the drafting ``hist`` and adaptive ``kslot``/``ema`` under speculative
    decode) let the destination continue token-identically.
    ``consumed`` flips on a successful import or restore: a payload is a
    one-shot move.
    """
    req: EngineRequest
    emitted: int
    tokens: list[int]
    cur: int                    # next token to emit (seeds dest decode)
    pos: int                    # == len(prompt) + emitted
    content: dict[str, torch.Tensor]
    kv_cache_dtype: str
    page_size: int
    hist: np.ndarray | None = None     # spec-decode drafting history, if any
    kslot: int = 0              # adaptive speculative window (0 = untracked)
    ema: float = 0.0            # accept-rate EMA riding along with kslot
    consumed: bool = False      # set by a successful import / restore
    reason: ExportReason = ExportReason.HANDOFF

    @property
    def n_content(self) -> int:
        return next(iter(self.content.values())).shape[2]

    def page_nbytes(self) -> int:
        """Bytes of ONE shipped page across every content leaf, data and
        scale pages alike: the one sizing truth that ship budgets, tier
        capacities and metrics multiply by a page count."""
        n = self.n_content
        return sum(a.numel() * a.element_size() // n
                   for a in self.content.values())

    @property
    def nbytes(self) -> int:
        """Bytes of the shipped pages, from :meth:`page_nbytes`."""
        return self.page_nbytes() * self.n_content


def _next_pow2(n: int) -> int:
    """Bucket size for wave-shaped device calls (1, 2, 4, ...)."""
    return 1 << max(0, n - 1).bit_length()


@dataclass
class _Admit:
    """A request accepted into the current admission wave."""
    slot: int
    req: EngineRequest
    pages: list[int]
    start: int                  # first position to prefill (= prefix match)
    group: int = 1              # intra-wave prefill stage (same-wave dedup)


class ContinuousBatchingEngine:
    """Continuous-batching decode over a shared paged KV pool (module doc).

    ``params`` must already live on ``device`` (default ``"cuda"``, which
    raises without CUDA; pass ``device="cpu"`` for the plain path).
    """

    def __init__(self, cfg, params, *, max_len: int = 512,
                 max_slots: int | None = None, num_pages: int | None = None,
                 decode_chunk: int | None = None,
                 prefill_chunk: int | None = None,
                 prefill_mode: str = "paged",
                 enable_prefix_cache: bool | None = None,
                 enable_spec_decode: bool | None = None,
                 spec_tokens: int | None = None,
                 spec_ngram: int | None = None,
                 kv_cache_dtype: str | None = None,
                 spec_adaptive_k: bool | None = None,
                 role: str = "unified", device="cuda"):
        if cfg.encoder_only:
            raise ValueError("encoder-only models cannot decode")
        if prefill_mode not in ("paged", "dense"):
            raise ValueError(f"prefill_mode must be 'paged' or 'dense', got "
                             f"{prefill_mode!r}")
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(f"role must be 'unified', 'prefill' or "
                             f"'decode', got {role!r}")
        self.device = resolve_device(device)
        leaf = params["embedding"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the engine on "
                             f"{self.device}: build them on the same device")
        self.role = role
        if role == "prefill":
            # A prefill replica never decodes, so speculation has nothing to
            # govern there.
            if enable_spec_decode:
                raise ValueError("role='prefill' engines never decode; "
                                 "enable_spec_decode is meaningless there")
            enable_spec_decode = False
            spec_adaptive_k = False
        self.kv_cache_dtype = cfg.kv_cache_dtype if kv_cache_dtype is None \
            else kv_cache_dtype
        if self.kv_cache_dtype not in ("f32", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'f32' or 'int8', got "
                             f"{self.kv_cache_dtype!r}")
        # Dense admission prefills an unquantized cache and re-lays it into
        # whole pages, past the quantize-on-scatter of the paged path.
        if self.kv_cache_dtype == "int8" and prefill_mode == "dense":
            raise ValueError("kv_cache_dtype='int8' requires "
                             "prefill_mode='paged' (dense prefill re-layouts "
                             "an unquantized cache into pool pages and "
                             "bypasses quantize-on-scatter)")
        # It also re-writes whole pad-rounded pages, which would clobber
        # aliased prefix pages: it runs without the prefix cache.
        if enable_prefix_cache and prefill_mode == "dense":
            raise ValueError("enable_prefix_cache=True requires "
                             "prefill_mode='paged' (dense prefill re-writes "
                             "whole pages and cannot alias shared prefixes)")
        self._step = build_paged_decode_step(cfg)
        self.cfg = cfg
        self.params = params
        self.family = get_family(cfg)
        if not hasattr(self.family, "decode_paged"):
            raise ValueError(f"{cfg.name}: the {self.family.name} family has "
                             "no paged decode path; serve it with "
                             "ServeEngine")
        self.page_size = cfg.page_size
        self.max_slots = cfg.max_decode_slots if max_slots is None \
            else max_slots
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        self.pages_per_seq = math.ceil(max_len / self.page_size)
        # +1: physical page 0 is the reserved idle-slot/pad write sink.
        self.num_pages = (num_pages or self.max_slots * self.pages_per_seq) + 1
        if enable_spec_decode is None:
            enable_spec_decode = cfg.enable_spec_decode
        self.spec_tokens = cfg.spec_tokens if spec_tokens is None \
            else spec_tokens
        self.spec_ngram = cfg.spec_ngram if spec_ngram is None else spec_ngram
        self.spec_decode = bool(enable_spec_decode)
        self.spec_adaptive_k = bool(
            cfg.spec_adaptive_k if spec_adaptive_k is None
            else spec_adaptive_k)
        if self.spec_adaptive_k and not self.spec_decode:
            raise ValueError("spec_adaptive_k=True requires "
                             "enable_spec_decode=True (the adaptive window "
                             "governs speculative drafting)")
        if self.spec_decode:
            k = self.spec_tokens
            if k < 1:
                raise ValueError(
                    f"enable_spec_decode requires spec_tokens >= 1, got {k} "
                    "(each verify step scores spec_tokens drafts + the "
                    "current token)")
            if self.spec_ngram not in (2, 3):
                raise ValueError(
                    f"spec_ngram must be 2 (bigram) or 3 (trigram draft "
                    f"keys), got {self.spec_ngram}")
            if k + 1 > self.pages_per_seq * self.page_size:
                raise ValueError(
                    f"spec_tokens+1 = {k + 1} verify rows exceed the "
                    f"{self.pages_per_seq * self.page_size}-row page-table "
                    f"window (max_len {max_len}, page_size "
                    f"{self.page_size}); shrink spec_tokens or raise "
                    "max_len")
        if decode_chunk is None:
            # Hold slots * chunk * tokens-per-step near decode_chunk_tokens:
            # narrow batches take long chunks to amortize the host sync, wide
            # ones short chunks so freed slots re-admit sooner. A spec step
            # emits up to K+1 tokens, so spec chunks shrink by that window.
            per_step = 1 + self.spec_tokens if self.spec_decode else 1
            decode_chunk = min(cfg.decode_chunk_max,
                               max(2, cfg.decode_chunk_min // per_step,
                                   cfg.decode_chunk_tokens
                                   // (self.max_slots * per_step)))
        self.decode_chunk = decode_chunk
        self.prefill_chunk = prefill_chunk or cfg.prefill_chunk
        if self.decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got "
                             f"{self.decode_chunk}")
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{self.prefill_chunk}")
        self.prefill_mode = prefill_mode

        self.pool = self.family.paged_pool(cfg, self.num_pages,
                                           self.kv_cache_dtype,
                                           device=self.device)
        self.alloc = PageAllocator(self.num_pages)
        if enable_prefix_cache is None:
            enable_prefix_cache = cfg.enable_prefix_cache
        self.prefix_cache = PrefixCache(self.page_size) \
            if enable_prefix_cache and prefill_mode == "paged" else None
        if self.prefix_cache is not None:
            self.alloc.on_alloc = self.prefix_cache.evict

        s = self.max_slots
        self._page_table = np.zeros((s, self.pages_per_seq), np.int32)
        self._pos = np.zeros(s, np.int32)
        self._cur = np.zeros(s, np.int32)
        self._active = np.zeros(s, bool)
        # Per-slot KV write limit (prompt_len + max_new): spec-decode draft
        # windows running past it are routed to the sink page.
        self._limit = np.zeros(s, np.int32)
        # Per-slot adaptive speculation: window (1..K) and accept-rate EMA,
        # updated once per chunk on the host.
        self._kslot = np.zeros(s, np.int32)
        self._ema = np.zeros(s, np.float64)
        # Per-slot token history for on-device drafting. The draft lookup
        # reads the first hist_len columns; the extra columns take the
        # writes past them (a spent slot's cursor runs up to K past its
        # budget, and drafts K more), which the reference's scatter drops.
        self.hist_len = self.pages_per_seq * self.page_size
        self._hist = torch.zeros(
            (s, self.hist_len + 2 * self.spec_tokens + 2), dtype=torch.int32,
            device=self.device) if self.spec_decode else None
        self._live: dict[int, _Live] = {}
        # Preempted requests parked host-side; their pages stay pinned.
        self._paused: dict[object, PausedRequest] = {}
        # Tier demotion: with ``demote_on_retire`` set (by the control plane
        # that attaches a tiered store), a finishing request is exported
        # (reason DEMOTE) before its pages are released, and its payload
        # waits in ``demoted_out`` for the store to drain.
        self.demote_on_retire = False
        self.demoted_out: list[ShippedKV] = []
        # Admission queue, consumed front-first by ``admit``.
        self._queue: deque[EngineRequest] = deque()
        self.stats: dict[str, float] = {}
        self._reset_stats()

        self._prefill_step = build_paged_prefill_step(cfg)
        self._prefill_ragged = build_prefill_ragged_step(cfg)
        if self.spec_decode:
            # Verify-window buckets: each chunk dispatches at the smallest
            # bucket covering every live slot's adaptive window. Powers of
            # two plus K itself; a fixed-K engine uses K only. The port's
            # kernels take any T*G, so no tile rule filters the buckets.
            if self.spec_adaptive_k:
                cand = {1 << i for i in range(self.spec_tokens.bit_length())}
                cand.add(self.spec_tokens)
                self._spec_buckets = sorted(
                    b for b in cand if b <= self.spec_tokens)
            else:
                self._spec_buckets = [self.spec_tokens]
            self._spec_steps: dict[int, object] = {}

    # -- stats ---------------------------------------------------------------
    _STAT_ZEROS = {"admitted": 0, "prefill_tokens": 0, "cached_tokens": 0,
                   "cow_copies": 0, "admit_seconds": 0.0,
                   "spec_steps": 0, "spec_emitted": 0,
                   "preempted": 0, "resumed": 0,
                   "page_exports": 0, "page_imports": 0,
                   "page_demotes": 0, "page_restores": 0,
                   "accept_ema_sum": 0.0, "accept_ema_n": 0}
    # Keys exported when bound to a MetricsRegistry; the scratch
    # accumulators (admit_seconds, the accept-EMA terms) stay local.
    _STAT_EXPORTED = ("admitted", "prefill_tokens", "cached_tokens",
                      "cow_copies", "spec_steps", "spec_emitted",
                      "preempted", "resumed", "page_exports", "page_imports",
                      "page_demotes", "page_restores")

    def _reset_stats(self):
        if isinstance(self.stats, RegistryDict):
            # Registry-bound: zero the local mirror in place; counters take
            # positive deltas only, so the bound series stay monotonic.
            for k, v in self._STAT_ZEROS.items():
                self.stats[k] = v
        else:
            self.stats = dict(self._STAT_ZEROS)

    def bind_registry(self, registry, engine: str) -> None:
        """Swap ``stats`` for a write-through view over ``registry``
        counters labelled ``{engine=...}``; totals so far carry into the
        series, and call sites keep the plain-dict idiom."""
        rd = RegistryDict()
        for key in self._STAT_EXPORTED:
            fam = registry.counter(
                f"kotta_engine_{key}_total",
                f"Engine {key.replace('_', ' ')} (cumulative)", ("engine",))
            rd.bind(key, fam, initial=self.stats[key], engine=engine)
        for key in self._STAT_ZEROS:
            if key not in self._STAT_EXPORTED:
                rd.bind(key, None, initial=self.stats[key])
        self.stats = rd

    @property
    def prefix_hit_rate(self) -> float:
        tot = self.stats["cached_tokens"] + self.stats["prefill_tokens"]
        return self.stats["cached_tokens"] / tot if tot else 0.0

    @property
    def mean_accepted_len(self) -> float:
        """Mean drafted tokens accepted per verify step (0 <= . <= K)."""
        steps = self.stats["spec_steps"]
        return (self.stats["spec_emitted"] - steps) / steps if steps else 0.0

    @property
    def mean_accept_ema(self) -> float:
        """Mean final per-slot accept-rate EMA over retired requests."""
        n = self.stats["accept_ema_n"]
        return self.stats["accept_ema_sum"] / n if n else 0.0

    def slot_spec_state(self) -> dict[int, dict[str, float]]:
        """Live per-slot adaptive-speculation state."""
        return {slot: {"kslot": int(self._kslot[slot]),
                       "accept_ema": float(self._ema[slot])}
                for slot in sorted(self._live)}

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- admission -----------------------------------------------------------
    def _admit_wave(self) -> int:
        """Admit requests from the queue, front-first, while slots and pages
        last.

        Each request consults the prefix cache within its namespace: fully
        matched pages are aliased (refcount++), a partially matched
        boundary page is copied, and only the suffix is prefilled, chunk by
        chunk and batched across the wave. A request's pages are registered
        the moment it is accepted, so a later request in the same wave can
        alias them; the wave is therefore prefilled in dependency groups,
        each group's copies dispatched after its donors' prefill.
        """
        t0 = time.perf_counter()
        ps = self.page_size
        wave: list[_Admit] = []
        cow_pairs: dict[int, list[tuple[int, int]]] = {}   # group -> pairs
        page_group: dict[int, int] = {}    # page -> group whose prefill fills it
        while self._queue:
            req = self._queue[0]
            prompt = req.prompt
            plen = len(prompt)
            free_slots = [i for i in range(self.max_slots)
                          if not self._active[i]]
            if not free_slots:
                break
            need_total = math.ceil((plen + req.max_new) / ps)
            if self.prefix_cache is not None:
                chain, raw = self.prefix_cache.lookup(prompt, req.namespace)
                # Always recompute the last prompt token: its logits seed
                # decode.
                match = min(raw, plen - 1)
            else:
                chain, match = [], 0
            n_alias, cow_m = divmod(match, ps)
            cow_src = chain[n_alias] if cow_m else None
            n_fresh = need_total - n_alias
            # Pin every matched page BEFORE allocating: a hit on a retired
            # request's page finds it in the free list, and an unpinned hit
            # could come back as one of our own fresh pages.
            shared = chain[:n_alias]
            for p in shared:
                self.alloc.share(p)
            if cow_src is not None:
                self.alloc.share(cow_src)
            if self.alloc.available() < n_fresh:
                for p in shared:                # not enough pages: wave ends
                    self.alloc.release(p)
                if cow_src is not None:
                    self.alloc.release(cow_src)
                break
            slot = free_slots[0]
            fresh = [self.alloc.alloc() for _ in range(n_fresh)]
            pages = shared + fresh
            deps = shared if cow_src is None else shared + [cow_src]
            group = 1 + max((page_group.get(p, 0) for p in deps), default=0)
            if cow_src is not None:
                cow_pairs.setdefault(group, []).append((cow_src, fresh[0]))
                self.stats["cow_copies"] += 1
            for p in fresh:
                page_group[p] = group
            self._active[slot] = True          # reserve within this wave
            row = np.zeros(self.pages_per_seq, np.int32)
            row[:len(pages)] = pages
            self._page_table[slot] = row
            self.stats["cached_tokens"] += match
            self.stats["prefill_tokens"] += plen - match
            wave.append(_Admit(slot, req, pages, match, group))
            if self.prefix_cache is not None:
                self.prefix_cache.register(prompt, pages, req.namespace)
            self._queue.popleft()

        if wave:
            for g in sorted({a.group for a in wave}):
                self._dispatch_cows(cow_pairs.get(g, ()))
                members = [a for a in wave if a.group == g]
                if self.prefill_mode == "dense":
                    self._prefill_dense(members)
                else:
                    self._prefill_paged_wave(members)
            for a in wave:
                self._live[a.slot] = _Live(a.req, a.pages)
            if self.spec_decode:
                self._load_histories(wave)
            self.stats["admitted"] += len(wave)
        self.stats["admit_seconds"] += time.perf_counter() - t0
        return len(wave)

    def _dispatch_cows(self, cow_pairs) -> None:
        """Copy a prefill group's boundary pages in place, padded to a pow2
        bucket (pad pairs copy sink -> sink). The page axis is 2 for every
        pool leaf, scale pages included."""
        if not cow_pairs:
            return
        n = _next_pow2(len(cow_pairs))
        src = np.zeros(n, np.int64)
        dst = np.zeros(n, np.int64)
        for i, (s_, d_) in enumerate(cow_pairs):
            src[i], dst[i] = s_, d_
        src_t, dst_t = self._dev(src), self._dev(dst)
        for leaf in self.pool.values():
            leaf[:, :, dst_t] = leaf[:, :, src_t]
        for s_, _ in cow_pairs:
            self.alloc.release(s_)              # pin no longer needed

    def _load_histories(self, wave: list[_Admit]) -> None:
        """Seed the drafting history and write limit of new slots."""
        rows = np.zeros((len(wave), self.hist_len), np.int32)
        slots = np.zeros(len(wave), np.int64)
        for i, a in enumerate(wave):
            rows[i, :len(a.req.prompt)] = a.req.prompt
            slots[i] = a.slot
            self._limit[a.slot] = len(a.req.prompt) + a.req.max_new
            # Speculation starts wide open; the per-chunk EMA update shrinks
            # the window if this request's drafts keep getting rejected.
            self._kslot[a.slot] = self.spec_tokens
            self._ema[a.slot] = 0.0
        self._hist[self._dev(slots), :self.hist_len] = self._dev(rows)

    def _prefill_paged_wave(self, wave: list[_Admit]) -> None:
        """Prefill every wave member's suffix in fixed-width chunk steps.

        The batch is padded to a power-of-two bucket; pad rows carry
        ``kv_len=0`` so all their KV writes land in the sink page.
        """
        c = self.prefill_chunk
        gp = _next_pow2(len(wave))
        page_tables = np.zeros((gp, self.pages_per_seq), np.int32)
        for i, a in enumerate(wave):
            page_tables[i] = self._page_table[a.slot]
        pt_dev = self._dev(page_tables)
        nsteps = max(math.ceil((len(a.req.prompt) - a.start) / c)
                     for a in wave)

        step_toks = []
        for j in range(nsteps):
            toks = np.zeros((gp, c), np.int32)
            qs = np.zeros(gp, np.int32)
            kl = np.zeros(gp, np.int32)
            li = np.zeros(gp, np.int32)
            for i, a in enumerate(wave):
                plen = len(a.req.prompt)
                s0 = a.start + j * c
                qs[i] = s0
                kl[i] = plen
                li[i] = plen - 1 - s0                 # clamped in the step
                seg = a.req.prompt[s0:s0 + c]
                if seg:
                    toks[i, :len(seg)] = seg
            batch = {"tokens": self._dev(toks), "q_start": self._dev(qs),
                     "kv_len": self._dev(kl), "page_table": pt_dev,
                     "logit_idx": self._dev(li)}
            nxt, _, self.pool = self._prefill_step(self.params, batch,
                                                   self.pool)
            step_toks.append(nxt)

        # The first token of request i comes from the chunk holding position
        # plen-1; sync each needed step once.
        host: dict[int, np.ndarray] = {}
        for i, a in enumerate(wave):
            j = (len(a.req.prompt) - 1 - a.start) // c
            if j not in host:
                host[j] = step_toks[j].cpu().numpy()
            self._cur[a.slot] = host[j][i]
            self._pos[a.slot] = len(a.req.prompt)

    def _prefill_dense(self, wave: list[_Admit]) -> None:
        """Dense admission: one ragged prefill per pad bucket (prompt length
        rounded up to whole pages), its cache re-laid into the requests'
        pages (``_write_pages``); one host sync a bucket for the first
        tokens."""
        ps = self.page_size
        by_pad: dict[int, list[_Admit]] = {}
        for a in wave:
            s_pad = math.ceil(len(a.req.prompt) / ps) * ps
            by_pad.setdefault(s_pad, []).append(a)
        for s_pad, items in by_pad.items():
            npp = s_pad // ps
            toks = np.zeros((len(items), s_pad), np.int32)
            lens = np.zeros(len(items), np.int32)
            for i, a in enumerate(items):
                toks[i, :len(a.req.prompt)] = a.req.prompt
                lens[i] = len(a.req.prompt)
            first, _, cache = self._prefill_ragged(
                self.params, {"tokens": self._dev(toks),
                              "length": self._dev(lens)})
            self._write_pages(cache["k"], cache["v"], np.concatenate(
                [np.asarray(a.pages[:npp], np.int64) for a in items]))
            first = first.cpu().numpy()
            for i, a in enumerate(items):
                self._pos[a.slot] = len(a.req.prompt)
                self._cur[a.slot] = first[i]

    def _write_pages(self, k, v, pages: np.ndarray) -> None:
        """Re-lay a prompt cache k/v (L,G,S_pad,KV,hd) into ``pages`` (G *
        S_pad / page_size,) of the pool, in place: request g's rows fill its
        pages in order."""
        nl, g, s_pad, nkv, hd = k.shape
        npp = g * (s_pad // self.page_size)
        dst = self._dev(pages)
        for name, rows in (("k", k), ("v", v)):
            leaf = self.pool[name]
            leaf[:, :, dst] = rows.reshape(
                nl, npp, self.page_size, nkv, hd).permute(
                    0, 3, 1, 2, 4).to(leaf.dtype)

    def _retire(self, slot: int) -> _Live:
        live = self._live.pop(slot)
        for p in live.pages:
            self.alloc.release(p)       # refcount--: aliased pages survive
        if self.spec_decode:
            self.stats["accept_ema_sum"] += float(self._ema[slot])
            self.stats["accept_ema_n"] += 1
        self._clear_slot(slot)
        return live

    def _debug_check_refcounts(self) -> None:
        """Every physical page's refcount == page-table rows referencing it
        (a paused request's pinned pages count as one reference each)."""
        counts = np.zeros(self.num_pages, np.int64)
        for held in (*self._live.values(), *self._paused.values()):
            for p in held.pages:
                counts[p] += 1
        if not np.array_equal(counts[1:], self.alloc.refs[1:]):
            bad = np.nonzero(counts[1:] != self.alloc.refs[1:])[0] + 1
            raise AssertionError(
                f"refcount drift on pages {bad.tolist()}: "
                f"rows={counts[bad].tolist()} refs={self.alloc.refs[bad].tolist()}")

    # -- stepped serving API -------------------------------------------------
    def _validate_request(self, req: EngineRequest) -> None:
        """Reject requests that can never run, before reserving anything."""
        p = req.prompt
        max_len = self.pages_per_seq * self.page_size
        pool_cap = self.num_pages - 1
        if not p:
            raise ValueError(f"request {req.rid}: empty prompt (nothing to "
                             "prefill)")
        if len(p) + req.max_new > max_len:
            raise ValueError(f"request {req.rid}: {len(p)}+{req.max_new} "
                             f"tokens exceed max_len {max_len}")
        need = math.ceil((len(p) + req.max_new) / self.page_size)
        if need > pool_cap:
            raise ValueError(
                f"request {req.rid}: needs {need} pages for "
                f"{len(p)}+{req.max_new} tokens but the pool only holds "
                f"{pool_cap}; raise num_pages or shorten the request")

    def enqueue(self, req: EngineRequest) -> None:
        """Append a validated request to the admission queue."""
        self._validate_request(req)
        self._queue.append(req)

    def admit(self) -> int:
        """Run one admission wave off the queue; returns requests admitted."""
        return self._admit_wave()

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def live(self) -> int:
        return len(self._live)

    @property
    def paused(self) -> int:
        return len(self._paused)

    @property
    def free_slots(self) -> int:
        """Unoccupied decode slots; paused requests hold pages but no slot,
        so this is what ``resume`` and ``import_pages`` need."""
        return int(self.max_slots - np.count_nonzero(self._active))

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._live or self._paused)

    @property
    def open_slots(self) -> int:
        """Slots not yet claimed by a live or queued request."""
        return self.max_slots - len(self._live) - len(self._queue)

    def remaining_tokens(self) -> list[int]:
        """Per live slot, tokens still to emit."""
        return [l.req.max_new - l.emitted for l in self._live.values()]

    def drop_queued(self) -> list[EngineRequest]:
        """Hand back queued-but-unadmitted requests; live and paused ones
        stay."""
        dropped = list(self._queue)
        self._queue.clear()
        return dropped

    def abort(self) -> list[EngineRequest]:
        """Drop all live, paused and queued requests and return them for
        re-enqueue. Pages, a paused request's pinned ones included, are
        released through the refcount path, so cached prefixes survive
        until reallocated."""
        dropped = [self._live[s].req for s in sorted(self._live)]
        for slot in list(self._live):
            self._retire(slot)
        for paused in self._paused.values():
            for p in paused.pages:
                self.alloc.release(p)
            dropped.append(paused.req)
        self._paused.clear()
        dropped.extend(self._queue)
        self._queue.clear()
        return dropped

    # -- preemption ------------------------------------------------------------
    def _clear_slot(self, slot: int) -> None:
        """Return a vacated slot to idle: all-zero page-table row (sink page
        0), zero cursor and write limit, no speculation state."""
        self._active[slot] = False
        self._page_table[slot] = 0
        self._pos[slot] = 0
        self._cur[slot] = 0
        self._limit[slot] = 0               # spec writes masked until re-seeded
        self._kslot[slot] = 0
        self._ema[slot] = 0.0

    def _hist_row(self, slot: int) -> np.ndarray | None:
        """The slot's drafting history (first ``hist_len`` columns) on the
        host, or None without speculative decode."""
        if not self.spec_decode:
            return None
        return self._hist[slot, :self.hist_len].cpu().numpy().copy()

    def _occupy(self, slot: int, req: EngineRequest, pages: list[int], *,
                emitted: int, tokens: list[int], cur: int, pos: int,
                limit: int, hist: np.ndarray, kslot: int,
                ema: float) -> None:
        """Attach a request mid-stream to a free slot: page-table row,
        cursor, write limit and, under speculative decode, the drafting
        history (one copy into the device row) and adaptive window."""
        row = np.zeros(self.pages_per_seq, np.int32)
        row[:len(pages)] = pages
        self._page_table[slot] = row
        self._active[slot] = True
        self._pos[slot] = pos
        self._cur[slot] = cur
        self._limit[slot] = limit
        if self.spec_decode:
            self._hist[slot, :self.hist_len].copy_(torch.from_numpy(hist))
            self._kslot[slot] = kslot
            self._ema[slot] = ema
        self._live[slot] = _Live(req, pages, emitted, tokens)

    def _free_slot(self, what: str) -> int:
        for i in range(self.max_slots):
            if not self._active[i]:
                return i
        raise CapacityError(f"no free slot to {what} into")

    def preempt(self, slot: int) -> PausedRequest:
        """Pause the request in ``slot`` mid-stream and free the slot.

        Its KV pages stay allocated and pinned (refcounts untouched), so no
        admission can reallocate them nor eviction scrub the prefix-cache
        entries they anchor. The cursor, emitted tokens, write limit and,
        under speculative decode, the drafting-history row (copied to the
        host) and adaptive window park in the returned
        :class:`PausedRequest`.
        """
        if slot not in self._live:
            raise KeyError(f"slot {slot} has no live request to preempt")
        live = self._live.pop(slot)
        paused = PausedRequest(
            req=live.req, pages=live.pages, emitted=live.emitted,
            tokens=live.tokens, cur=int(self._cur[slot]),
            pos=int(self._pos[slot]), limit=int(self._limit[slot]),
            hist=self._hist_row(slot), kslot=int(self._kslot[slot]),
            ema=float(self._ema[slot]))
        self._paused[live.req.rid] = paused
        # As _retire, except the pages are not released.
        self._clear_slot(slot)
        self.stats["preempted"] += 1
        return paused

    def resume(self, paused: PausedRequest) -> int:
        """Re-admit a preempted request into a free slot; returns the slot.

        Zero re-prefill: the parked pages are re-attached through the page
        table and the cursor, limit and history restored, so greedy tokens
        equal a never-paused run's. Raises ``RuntimeError`` when every slot
        is occupied (check :attr:`free_slots` first).
        """
        if self._paused.get(paused.req.rid) is not paused:
            raise KeyError(f"request {paused.req.rid} is not paused on this "
                           "engine")
        slot = self._free_slot("resume")
        del self._paused[paused.req.rid]
        # kslot 0: paused before this engine tracked it; re-warm from K.
        self._occupy(slot, paused.req, paused.pages, emitted=paused.emitted,
                     tokens=paused.tokens, cur=paused.cur, pos=paused.pos,
                     limit=paused.limit, hist=paused.hist,
                     kslot=paused.kslot or self.spec_tokens, ema=paused.ema)
        self.stats["resumed"] += 1
        return slot

    # -- page residency: one export, two ways back in ---------------------------
    def export(self, slot: int | None = None, *, rid: object = None,
               reason: ExportReason = ExportReason.HANDOFF) -> ShippedKV:
        """Ship a request out of this engine as a :class:`ShippedKV`.

        ``slot=`` takes a live request (gathered, then retired through the
        refcount path), ``rid=`` a request parked by :meth:`preempt`
        (gathered, then unpinned); exactly one must be given, since slot
        numbers and caller rids can share values. ``reason`` tags the
        payload without changing the gather.

        Only content pages travel, ``ceil(pos / page_size)`` of them;
        trailing pages allocated against the decode budget are empty and
        are released. Aliased prefix pages are gathered like any other, so
        the payload is a private copy, and this engine's prefix-cache
        entries survive. Works mid-decode: the payload carries the decoded
        rows, emitted tokens and (speculative decode) the drafting history
        and adaptive window.
        """
        if (slot is None) == (rid is None):
            raise ValueError("export needs exactly one of slot= (live "
                             "request) or rid= (paused request)")
        if slot is not None:
            if slot not in self._live:
                raise KeyError(f"slot {slot} has no live request to export")
            live = self._live[slot]
            payload = self._export(
                req=live.req, emitted=live.emitted, tokens=list(live.tokens),
                cur=int(self._cur[slot]), pos=int(self._pos[slot]),
                pages=live.pages, hist=self._hist_row(slot),
                kslot=int(self._kslot[slot]), ema=float(self._ema[slot]),
                reason=reason)
            self._retire(slot)
            return payload
        paused = self._paused.get(rid)
        if paused is None:
            raise KeyError(f"request {rid} is not paused on this engine")
        payload = self._export(
            req=paused.req, emitted=paused.emitted,
            tokens=list(paused.tokens), cur=paused.cur, pos=paused.pos,
            pages=paused.pages, hist=paused.hist, kslot=paused.kslot,
            ema=paused.ema, reason=reason)
        del self._paused[rid]
        for p in paused.pages:
            self.alloc.release(p)       # unpin: aliased pages survive
        return payload

    def export_pages(self, slot: int, *,
                     reason: ExportReason = ExportReason.HANDOFF
                     ) -> ShippedKV:
        """Alias of ``export(slot=...)``."""
        return self.export(slot=slot, reason=reason)

    def export_paused(self, rid: object, *,
                      reason: ExportReason = ExportReason.EVACUATE
                      ) -> ShippedKV:
        """Alias of ``export(rid=...)``."""
        return self.export(rid=rid, reason=reason)

    def _export(self, *, req, emitted, tokens, cur, pos, pages, hist,
                kslot, ema, reason: ExportReason) -> ShippedKV:
        """Gather the ``ceil(pos / page_size)`` content pages: one
        ``index_select`` a pool leaf, then its copy to the host."""
        n_content = math.ceil(pos / self.page_size)
        idx = self._dev(np.asarray(pages[:n_content], np.int64))
        content = {name: leaf.index_select(2, idx).cpu()
                   for name, leaf in self.pool.items()}
        self.stats["page_exports"] += 1
        return ShippedKV(
            req=req, emitted=emitted, tokens=tokens, cur=cur, pos=pos,
            content=content, kv_cache_dtype=self.kv_cache_dtype,
            page_size=self.page_size, hist=hist, kslot=kslot, ema=ema,
            reason=reason)

    def page_nbytes(self) -> int:
        """Bytes of ONE shipped page across every pool leaf (data and scale
        pages), what a planner multiplies by a request's content-page count
        to budget a move without exporting first."""
        return sum(leaf.numel() * leaf.element_size() // leaf.shape[2]
                   for leaf in self.pool.values())

    def _check_payload(self, payload: ShippedKV, verb: str) -> None:
        """Refuse a consumed payload or one whose layout is not this pool's
        (pool dtype, page size, leaf names, each leaf's shape and dtype)."""
        if payload.consumed:
            raise ValueError(
                f"payload for request {payload.req.rid} was already "
                "imported or restored; a ShippedKV is a one-shot move")
        if payload.kv_cache_dtype != self.kv_cache_dtype:
            raise ValueError(
                f"{verb} pages are {payload.kv_cache_dtype!r} but this "
                f"engine's pool is {self.kv_cache_dtype!r}")
        if payload.page_size != self.page_size:
            raise ValueError(
                f"{verb} page_size {payload.page_size} != engine "
                f"page_size {self.page_size}")
        if set(payload.content) != set(self.pool):
            raise ValueError(
                f"{verb} pool leaves {sorted(payload.content)} != engine "
                f"pool leaves {sorted(self.pool)}")
        n = payload.n_content
        for name, leaf in self.pool.items():
            a = payload.content[name]
            want = leaf.shape[:2] + (n,) + leaf.shape[3:]
            if tuple(a.shape) != tuple(want) or a.dtype != leaf.dtype:
                raise ValueError(
                    f"{verb} leaf {name!r} is {tuple(a.shape)} {a.dtype}; "
                    f"this pool takes {tuple(want)} {leaf.dtype}")

    def _scatter(self, payload: ShippedKV, pages: list[int]) -> None:
        """Write the payload's content pages into ``pages`` of the pool, in
        place, one indexed copy a leaf."""
        dst = self._dev(np.asarray(pages[:payload.n_content], np.int64))
        for name, leaf in self.pool.items():
            leaf[:, :, dst] = payload.content[name].to(self.device)

    def import_pages(self, payload: ShippedKV) -> int:
        """Re-register a :class:`ShippedKV` here as a live request; returns
        the slot.

        Fresh pages come from this engine's allocator (the whole
        prompt + budget span), the content scatters into them in place, the
        prompt re-registers in this engine's prefix cache (existing entries
        win, as at admission) and decoding resumes where the source
        stopped. Raises ``ValueError`` on a layout mismatch or a consumed
        payload and :class:`CapacityError` (a ``RuntimeError``) when no slot
        or not enough pages are free; only a successful import marks the
        payload consumed.
        """
        self._check_payload(payload, "shipped")
        req = payload.req
        self._validate_request(req)
        if payload.pos != len(req.prompt) + payload.emitted:
            raise ValueError(
                f"inconsistent payload for request {req.rid}: pos "
                f"{payload.pos} != prompt {len(req.prompt)} + emitted "
                f"{payload.emitted}")
        slot = self._free_slot("import")
        need_total = math.ceil((len(req.prompt) + req.max_new)
                               / self.page_size)
        if payload.n_content > need_total:
            raise ValueError(
                f"payload ships {payload.n_content} content pages but "
                f"request {req.rid} spans only {need_total}")
        if self.alloc.available() < need_total:
            raise CapacityError(
                f"insufficient free pages to import request {req.rid}: "
                f"need {need_total}, have {self.alloc.available()}")
        pages = [self.alloc.alloc() for _ in range(need_total)]
        self._scatter(payload, pages)
        hist = None
        if self.spec_decode:
            # The source's row if it ran speculative decode too, else
            # rebuilt from prompt + emitted tokens (the same content: draft
            # tails past pos are rewritten before they are read).
            if payload.hist is not None and                     len(payload.hist) == self.hist_len:
                hist = np.asarray(payload.hist, np.int32)
            else:
                hist = np.zeros(self.hist_len, np.int32)
                hist[:len(req.prompt)] = req.prompt
                hist[len(req.prompt):payload.pos] = payload.tokens[
                    :payload.pos - len(req.prompt)]
        # The source's tuned window, capped at this engine's K (0: the
        # source never tracked one, warm from K).
        self._occupy(slot, req, pages, emitted=payload.emitted,
                     tokens=list(payload.tokens), cur=payload.cur,
                     pos=payload.pos,
                     limit=len(req.prompt) + req.max_new, hist=hist,
                     kslot=min(payload.kslot, self.spec_tokens)
                     or self.spec_tokens, ema=payload.ema)
        if self.prefix_cache is not None:
            self.prefix_cache.register(req.prompt, pages, req.namespace)
        self.stats["page_imports"] += 1
        payload.consumed = True
        return slot

    def restore_pages(self, payload: ShippedKV) -> list[int]:
        """Land a demoted payload's content pages back in the pool without
        taking a slot; returns the restored pages.

        The content scatters into freshly allocated pages, the covered
        token stream (prompt + emitted tokens) is registered in the prefix
        cache under the payload's namespace, and the pages drop straight to
        refcount 0: free-but-hittable, as a retired request's pages are.
        The next admission of a prompt that extends the stream aliases them
        with zero re-prefill; if none does, the allocator reuses them and
        eviction scrubs the entries. Raises ``ValueError`` on a layout
        mismatch or a consumed payload, ``RuntimeError`` without the prefix
        cache and :class:`CapacityError` without enough free pages.
        """
        self._check_payload(payload, "restored")
        if self.prefix_cache is None:
            raise RuntimeError("restore_pages needs the prefix cache: "
                               "restored pages are only reachable through "
                               "the radix index")
        n_content = payload.n_content
        if self.alloc.available() < n_content:
            raise CapacityError(
                f"insufficient free pages to restore request "
                f"{payload.req.rid}: need {n_content}, have "
                f"{self.alloc.available()}")
        pages = [self.alloc.alloc() for _ in range(n_content)]
        self._scatter(payload, pages)
        req = payload.req
        stream = list(req.prompt) + list(
            payload.tokens[:payload.pos - len(req.prompt)])
        self.prefix_cache.register(stream, pages, req.namespace)
        for p in pages:
            self.alloc.release(p)       # free-but-hittable, like retirement
        self.stats["page_restores"] += 1
        payload.consumed = True
        return pages

    # -- decode chunks ---------------------------------------------------------
    def _decode_chunk(self, cur, pos, page_table, active, budget):
        """``decode_chunk`` plain decode steps on the device, no host sync.

        A slot whose budget is spent mid-chunk must stop writing KV: its
        page-table row is masked to the all-zero sink row, so overshoot
        steps cannot clobber its last real page (which the prefix cache may
        share).
        """
        out = torch.zeros((self.max_slots, self.decode_chunk),
                          dtype=torch.int32, device=self.device)
        for i in range(self.decode_chunk):
            out[:, i] = cur
            live = active & (budget > i)
            pt = torch.where(live[:, None], page_table, 0)
            batch = {"tokens": cur[:, None], "pos": pos, "page_table": pt}
            nxt, _, self.pool = self._step(self.params, batch, self.pool)
            cur = torch.where(live, nxt, cur)
            pos = torch.where(live, pos + 1, pos)
        return cur, pos, out

    def _spec_chunk(self, kb, cur, pos, page_table, active, budget, limit,
                    kslot):
        """``decode_chunk`` fused draft+verify steps at window bucket ``kb``.

        Each step writes ``cur`` into the history, drafts ``kb`` tokens,
        verifies the window ``[cur | drafts]`` in one pass, accepts the
        longest draft prefix the model agrees with (capped at the slot's own
        window ``kslot``) and emits it plus the correction.
        """
        fstep = self._spec_steps.get(kb)
        if fstep is None:
            fstep = self._spec_steps[kb] = build_fused_spec_step(
                self.cfg, build_ngram_draft(self.hist_len, kb,
                                            self.spec_ngram))
        s, dev = self.max_slots, self.device
        t_spec = kb + 1
        width = self.decode_chunk * t_spec
        # t_spec extra columns take the writes of slots that are not live
        # (the reference's scatter drops them).
        out = torch.zeros((s, width + t_spec), dtype=torch.int32, device=dev)
        n_out = torch.zeros(s, dtype=torch.int32, device=dev)
        n_it = torch.zeros(s, dtype=torch.int32, device=dev)
        bidx = torch.arange(s, device=dev)
        ar_k = torch.arange(kb, device=dev)
        ar_t = torch.arange(t_spec, device=dev)
        hist = self._hist
        for _ in range(self.decode_chunk):
            live = active & (n_out < budget)
            # hist[:pos+1] becomes the exact verified stream the draft reads.
            hist[bidx, pos.long()] = cur
            batch = {"cur": cur, "pos": pos, "hist": hist[:, :self.hist_len],
                     "page_table": torch.where(live[:, None], page_table, 0),
                     "write_limit": torch.where(live, limit, 0)}
            window, drafts, nxt, self.pool = fstep(self.params, batch,
                                                   self.pool)
            # Drafts become history; the tail past the next pos is rewritten
            # before it is read.
            hist[bidx[:, None], pos.long()[:, None] + 1 + ar_k[None]] = drafts
            match = (drafts == nxt[:, :kb]) & (ar_k[None] < kslot[:, None])
            a = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
            base = torch.where(live, n_out, width)
            out[bidx[:, None], base.long()[:, None] + ar_t[None]] = window
            n_out = n_out + torch.where(live, 1 + a, 0).to(torch.int32)
            n_it = n_it + live.to(torch.int32)
            cur = torch.where(live, nxt[bidx, a], cur)
            pos = torch.where(live, pos + 1 + a, pos).to(torch.int32)
        return cur, pos, n_out, n_it, out[:, :width]

    def decode_step(self, on_chunk=None) -> list[tuple[EngineRequest,
                                                       list[int]]]:
        """Run ONE decode chunk on the device; returns finished requests.

        ``on_chunk(steps, seconds)`` (optional) observes the chunk; ``steps``
        is the chunk's device trip count, always ``decode_chunk``.
        """
        if self.role == "prefill":
            raise RuntimeError("decode_step on a prefill-role engine")
        if not self._live:
            return []
        budget = np.zeros(self.max_slots, np.int32)
        for slot, live in self._live.items():
            budget[slot] = live.req.max_new - live.emitted
        t0 = time.perf_counter()
        cur, pos = self._dev(self._cur), self._dev(self._pos)
        page_table, active = self._dev(self._page_table), self._dev(self._active)
        if self.spec_decode:
            kslot = np.maximum(np.where(self._active, self._kslot, 1), 1)
            kmax = int(kslot[self._active].max())
            kb = min(b for b in self._spec_buckets if b >= kmax)
            cur, pos, n_out, n_it, out = self._spec_chunk(
                kb, cur, pos, page_table, active, self._dev(budget),
                self._dev(self._limit), self._dev(kslot.astype(np.int32)))
            n_out_host = n_out.cpu().numpy()
            n_it_host = n_it.cpu().numpy()
            self.stats["spec_steps"] += int(n_it_host.sum())
            # Per-slot accept-rate EMA (alpha 0.5) and adaptive window:
            # x2 above 0.8 (capped at K), /2 below 0.3 (floor 1).
            for slot in self._live:
                it = int(n_it_host[slot])
                if not it:
                    continue
                rate = (int(n_out_host[slot]) - it) / (it * int(kslot[slot]))
                self._ema[slot] = 0.5 * self._ema[slot] + 0.5 * rate
                if self.spec_adaptive_k:
                    if self._ema[slot] > 0.8:
                        self._kslot[slot] = min(2 * int(self._kslot[slot]),
                                                self.spec_tokens)
                    elif self._ema[slot] < 0.3:
                        self._kslot[slot] = max(int(self._kslot[slot]) // 2,
                                                1)
        else:
            cur, pos, out = self._decode_chunk(cur, pos, page_table, active,
                                               self._dev(budget))
            n_out_host = None              # every live slot emits the chunk
        out_host = out.cpu().numpy()                    # one sync per chunk
        if on_chunk is not None:
            on_chunk(self.decode_chunk, time.perf_counter() - t0)
        self._cur = cur.cpu().numpy().copy()
        self._pos = pos.cpu().numpy().copy()
        finished: list[tuple[EngineRequest, list[int]]] = []
        for slot in list(self._live):
            live = self._live[slot]
            ntok = self.decode_chunk if n_out_host is None \
                else int(n_out_host[slot])
            if n_out_host is not None:
                # Count only delivered tokens: the last verify step can
                # overshoot the budget.
                self.stats["spec_emitted"] += min(
                    ntok, live.req.max_new - live.emitted)
            live.tokens.extend(out_host[slot, :ntok].tolist())
            live.emitted += ntok
            if live.emitted >= live.req.max_new:
                finished.append((live.req, live.tokens[:live.req.max_new]))
                if self.demote_on_retire:
                    self._demote(slot)
                else:
                    self._retire(slot)
        return finished

    def _demote(self, slot: int) -> None:
        """Export a finished request (reason DEMOTE) into ``demoted_out``
        before its pages are released, so an eviction that later scrubs
        its index entries finds the content already off the device.

        The payload is trimmed to what the request delivered: ``max_new``
        tokens and ``pos = prompt + max_new``. A chunk runs past a spent
        budget (plain decode emits the whole chunk; a speculative step can
        carry the cursor past the write limit, whose rows are never
        written), and the reference ships that overshoot as if it were
        content.
        """
        live = self._live[slot]
        max_new = live.req.max_new
        live.emitted = max_new
        del live.tokens[max_new:]
        self._pos[slot] = len(live.req.prompt) + max_new
        self.demoted_out.append(self.export(slot=slot,
                                            reason=ExportReason.DEMOTE))
        self.stats["page_demotes"] += 1

    # -- the serving loop ----------------------------------------------------
    def generate(self, prompts: list[list[int]], max_new: int = 16,
                 on_chunk=None) -> ServeResult:
        """Greedy-decode ``max_new`` tokens for every prompt, FCFS admission,
        as a loop over the stepped API."""
        if not prompts:
            return ServeResult(np.zeros((0, max_new), np.int32), [])
        if self.has_work:
            raise RuntimeError("generate() on a busy engine: drain or abort "
                               "the stepped API first")
        reqs = [EngineRequest(rid, list(p), max_new)
                for rid, p in enumerate(prompts)]
        for r in reqs:                        # validate before reserving
            self._validate_request(r)
        self._reset_stats()
        self._queue.extend(reqs)
        done: dict[object, list[int]] = {}
        self._admit_wave()
        if self._queue and not self._live:
            raise RuntimeError("admission stalled: request needs more pages "
                               "than the pool holds free")
        while self._live:
            for req, toks in self.decode_step(on_chunk=on_chunk):
                done[req.rid] = toks
            self._admit_wave()
            if self._queue and not self._live:
                raise RuntimeError("admission stalled: request needs more "
                                   "pages than the pool holds free")
        tokens = np.stack([np.asarray(done[i], np.int32)
                           for i in range(len(prompts))])
        return ServeResult(tokens, [len(p) for p in prompts])
