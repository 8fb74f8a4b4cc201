"""Refcounted page allocation and page-granular prefix caching.

The serving analogue of Cloud Kotta's tiered storage: the paper keeps ONE
copy of a hot shared dataset that many jobs read, instead of one copy per
job. Here the "dataset" is the KV cache of a common prompt prefix (system
prompt, few-shot header) and the "jobs" are decode requests:

- ``PageAllocator`` tracks a reference count per physical pool page. A page
  is *free* when no page-table row references it — but its contents stay
  valid until the page is actually reallocated, so a free page can be
  revived by a later cache hit (the storage-tier move: demoted, not
  destroyed).
- ``PrefixCache`` is a radix index over page-size token chunks: full pages
  are keyed ``(parent_page, page_tokens)`` so lookup walks the prompt one
  page at a time; a final sub-page remainder is kept as a *partial* entry
  under its parent, which is what lets admission copy-on-write the one
  boundary page instead of re-prefilling it.
- Every walk starts at a **namespace root** (default ``None``): the gateway
  namespaces prefix keys by (tenant, data-zone), so one tenant's cached KV
  pages can never be aliased into another tenant's request — deeper radix
  keys are parented by physical page ids, which are only reachable by first
  matching through the namespace's own root. This is the paper's §VI
  isolation guarantee carried down to the KV cache: shared *within* a
  security domain, invisible *across* domains.

The allocator's ``on_alloc`` hook evicts a page's index entries the moment
the page is repurposed, and recursively scrubs the subtree it anchored:
physical page ids are the radix parents, so entries must never outlive the
page contents they describe.

For fleet routing, ``PrefixCache.fingerprint`` summarises the whole index as
a flat set of namespace-salted **chain hashes** (:func:`chain_hashes`): one
hash per fully cached page-granular prefix, rolling from the namespace root
down the radix chain. A router can score "how many prefix pages of THIS
prompt does THAT replica already hold" from the fingerprint alone — no token
content crosses the wire, and a (vanishingly unlikely) hash collision can
only misroute a request, never alias pages: real admission still walks the
namespace-scoped radix tree.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

_FP_SALT = "kotta-prefix-fp"


@dataclass(frozen=True)
class EvictionEvent:
    """One :meth:`PrefixCache.evict` call's worth of index removals.

    The explicit eviction contract: ``pages`` is every page whose index
    entry was dropped (the reallocated page plus the scrubbed subtree it
    anchored), ``namespace`` is the (tenant, data-zone) domain those
    entries lived under — subtrees are namespace-pure, rooted at the
    namespace's own root — and ``epoch`` is the cache epoch after the
    removals. Subscribers (tier demotion, accounting) observe "these pages
    left the index" at the only moment it is knowable; every page in the
    event is either already demoted to a lower tier or refcount-zero free,
    never silently lost.
    """

    pages: tuple
    namespace: object
    epoch: int


def chain_hashes(prompt, page_size: int, namespace=None) -> list[int]:
    """Rolling chain hash of every full-page prefix of ``prompt``.

    ``out[i]`` identifies the (namespace, first ``(i+1)*page_size`` tokens)
    prefix; it extends ``out[i-1]``, so a replica fingerprint containing
    ``out[i]`` implies the whole chain up to page ``i`` is cached there
    (fingerprints are prefix-closed: eviction scrubs subtrees rootward-in).
    The namespace salts the seed, so identical token content under two
    (tenant, data-zone) namespaces never produces matching hashes — the
    router inherits the cache's isolation for free.
    """
    h = hash((_FP_SALT, namespace))
    out = []
    for i in range(len(prompt) // page_size):
        h = hash((h, tuple(prompt[i * page_size:(i + 1) * page_size])))
        out.append(h)
    return out


_ALL_NAMESPACES = object()


class PageAllocator:
    """Refcounted free-list over physical pages 1..num_pages-1 (0 = sink)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self.refs = np.zeros(num_pages, np.int64)
        self._free = list(range(num_pages - 1, 0, -1))      # LIFO: 1 on top
        self._free_set = set(self._free)
        self.on_alloc = None            # callback(page) on reallocation

    def available(self) -> int:
        return len(self._free_set)

    def alloc(self) -> int:
        """Pop a free page; its old cached identity (if any) is evicted."""
        while self._free:
            p = self._free.pop()
            if p not in self._free_set:
                continue                 # stale entry: page was revived
            self._free_set.discard(p)
            if self.on_alloc is not None:
                self.on_alloc(p)
            self.refs[p] = 1
            return p
        raise RuntimeError("page pool exhausted")

    def share(self, p: int) -> None:
        """Add a reference; revives a free-but-still-valid cached page."""
        if self.refs[p] == 0:
            self._free_set.discard(p)    # its list entry goes stale
        self.refs[p] += 1

    def release(self, p: int) -> None:
        self.refs[p] -= 1
        assert self.refs[p] >= 0, f"page {p} over-released"
        if self.refs[p] == 0 and p not in self._free_set:
            self._free.append(p)
            self._free_set.add(p)


class PrefixCache:
    """Radix index from prompt-token chunks to the pool pages holding them.

    Holds NO page references itself: a cached page may have refcount 0 (all
    requests using it retired) and sit in the free list; it stays hittable
    until the allocator hands it out again, at which point ``evict`` removes
    it (and the subtree keyed under it) from the index.
    """

    # Fingerprint-delta journal depth: one entry per full-entry add/remove.
    # A consumer further behind than this takes a fresh snapshot (the
    # journal can't replay what it no longer holds).
    JOURNAL_DEPTH = 8192

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._full = {}      # (parent_page|-1, tokens) -> page
        self._partial = {}   # parent_page|-1 -> list[(tokens, page)]
        # page -> ("full", key, ns) | ("partial", parent, toks, ns); the
        # trailing namespace is carried so EvictionEvents can name the
        # domain an entry lived under without re-walking to its root.
        self._owned = {}
        self._kids = {}      # parent_page -> list of full keys under it
        # Explicit eviction contract: callback(EvictionEvent) fired once
        # per evict() that removed at least one entry. Demotion subscribes
        # here — the single seam where "a page left the index" is
        # observable.
        self.on_evict = None
        # Incremental fingerprint: chain hash per owned full entry, plus an
        # epoch-tagged add/remove journal so routers can mirror the
        # fingerprint with deltas instead of a full snapshot per round.
        # Every mutation bumps ``epoch`` by exactly one and appends exactly
        # one journal entry, so the journal always covers the contiguous
        # epoch range (epoch - len(journal), epoch].
        self._chain = {}     # page -> chain hash (full entries only)
        self.epoch = 0
        self._journal: deque = deque(maxlen=self.JOURNAL_DEPTH)

    def _record(self, sign: int, h: int) -> None:
        self.epoch += 1
        self._journal.append((self.epoch, sign, h))

    @staticmethod
    def _root(namespace):
        """Radix root for ``namespace``; distinct from every physical page
        id, so cross-namespace walks can never meet."""
        return ("root", namespace)

    # -- lookup --------------------------------------------------------------
    def lookup(self, prompt, namespace=None) -> tuple[list[int], int]:
        """Longest cached prefix of ``prompt`` within ``namespace``.

        Returns (chain, match_len): ``chain`` holds the full pages covering
        ``match_len // page_size`` pages plus, if ``match_len`` ends
        mid-page, the page holding that partial tail (the copy-on-write
        source). Entries registered under a different namespace are
        unreachable: the walk starts at the namespace's own root.
        """
        ps = self.page_size
        chain: list[int] = []
        parent, i = self._root(namespace), 0
        while (i + 1) * ps <= len(prompt):
            page = self._full.get((parent, tuple(prompt[i * ps:(i + 1) * ps])))
            if page is None:
                break
            chain.append(page)
            parent = page
            i += 1
        match = i * ps
        best_toks, best_page = (), -1
        for toks, page in self._partial.get(parent, ()):
            if len(toks) > len(best_toks) and \
                    tuple(prompt[match:match + len(toks)]) == toks:
                best_toks, best_page = toks, page
        if best_page >= 0:
            chain.append(best_page)
            match += len(best_toks)
        return chain, match

    # -- registration --------------------------------------------------------
    def register(self, prompt, pages, namespace=None) -> None:
        """Record a freshly prefilled prompt's pages under ``namespace``.

        Existing entries win (their pages are what later lookups alias); our
        private duplicate simply stays out of the index. ``pages`` is the
        request's page list: ``pages[i]`` holds rows [i*ps, (i+1)*ps).
        The same token content registered under two namespaces keeps two
        physical copies — exactly the tenant-isolation requirement.
        """
        ps = self.page_size
        parent = self._root(namespace)
        parent_hash = hash((_FP_SALT, namespace))
        n_full = len(prompt) // ps
        for i in range(n_full):
            tup = tuple(prompt[i * ps:(i + 1) * ps])
            key = (parent, tup)
            page = self._full.get(key)
            if page is None:
                page = pages[i]
                self._full[key] = page
                self._owned[page] = ("full", key, namespace)
                self._kids.setdefault(parent, []).append(key)
                self._chain[page] = hash((parent_hash, tup))
                self._record(+1, self._chain[page])
            parent_hash = self._chain[page]
            parent = page
        rem = tuple(prompt[n_full * ps:])
        if rem and n_full < len(pages):
            lst = self._partial.setdefault(parent, [])
            if all(toks != rem for toks, _ in lst):
                lst.append((rem, pages[n_full]))
                self._owned[pages[n_full]] = ("partial", parent, rem,
                                              namespace)

    # -- eviction ------------------------------------------------------------
    def evict(self, page: int) -> None:
        """Drop ``page``'s entries: its physical contents are being reused.

        Fires ``on_evict`` with one :class:`EvictionEvent` covering the
        page and its scrubbed subtree when any entry was removed.
        """
        dropped: list[tuple[int, object]] = []   # (page, namespace)
        owned = self._owned.pop(page, None)
        if owned is not None:
            dropped.append((page, owned[-1]))
            if owned[0] == "full":
                self._full.pop(owned[1], None)
                ch = self._chain.pop(page, None)
                if ch is not None:
                    self._record(-1, ch)
                # Also unlink from the parent's child list: namespace roots
                # are never scrubbed, so a stale key left here would leak
                # one entry per eviction for the gateway's lifetime.
                kids = self._kids.get(owned[1][0])
                if kids is not None:
                    try:
                        kids.remove(owned[1])
                    except ValueError:
                        pass
                    if not kids:
                        del self._kids[owned[1][0]]
            else:
                _, parent, toks, _ns = owned
                lst = self._partial.get(parent)
                if lst is not None:
                    lst[:] = [e for e in lst if e[0] != toks]
        # Entries keyed under this page id would silently re-anchor to the
        # page's NEW contents — scrub the whole subtree.
        self._scrub(page, dropped)
        if dropped and self.on_evict is not None:
            self.on_evict(EvictionEvent(
                pages=tuple(p for p, _ in dropped),
                namespace=dropped[0][1],
                epoch=self.epoch))

    def _scrub(self, page: int,
               dropped: list[tuple[int, object]] | None = None) -> None:
        for key in self._kids.pop(page, ()):
            child = self._full.pop(key, None)
            if child is not None:
                ent = self._owned.get(child)
                if ent is not None and ent[0] == "full" and ent[1] == key:
                    del self._owned[child]
                    if dropped is not None:
                        dropped.append((child, ent[2]))
                    ch = self._chain.pop(child, None)
                    if ch is not None:
                        self._record(-1, ch)
                    self._scrub(child, dropped)
        for toks, child in self._partial.pop(page, ()):
            ent = self._owned.get(child)
            if ent is not None and ent[0] == "partial" and ent[1] == page \
                    and ent[2] == toks:
                del self._owned[child]
                if dropped is not None:
                    dropped.append((child, ent[3]))

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        return len(self._full) + sum(len(v) for v in self._partial.values())

    def fingerprint(self, namespace=_ALL_NAMESPACES) -> frozenset:
        """Compact advertisement of every fully cached page-granular prefix.

        Returns the set of :func:`chain_hashes` values reachable from the
        namespace root(s): one hash per cached full page, chained through
        its radix ancestry. The set is *prefix-closed* — registration adds
        every depth along the chain and eviction scrubs subtrees rootward-in
        — so a router can score a prompt by counting consecutive hits of its
        own ``chain_hashes`` against this set (stop at the first miss).
        Partial (sub-page) entries are deliberately excluded: they only save
        a copy-on-write, not prefill FLOPs, so they don't move routing.

        By default all namespaces are merged (the router scores a request
        with the request's OWN namespace salt, so cross-namespace hashes
        can't collide by construction); pass ``namespace=`` to advertise a
        single domain.
        """
        fp = set()
        if namespace is _ALL_NAMESPACES:
            roots = [r for r in self._kids
                     if isinstance(r, tuple) and r[0] == "root"]
        else:
            roots = [self._root(namespace)]
        for root in roots:
            seed = hash((_FP_SALT, root[1]))
            stack = [(root, seed)]
            while stack:
                parent, h = stack.pop()
                for key in self._kids.get(parent, ()):
                    page = self._full.get(key)
                    if page is None:
                        continue
                    ch = hash((h, key[1]))
                    fp.add(ch)
                    stack.append((page, ch))
        return frozenset(fp)

    def fingerprint_delta(self, since_epoch: int
                          ) -> tuple[int, frozenset, frozenset] | None:
        """Fingerprint changes (all namespaces) since ``since_epoch``.

        Returns ``(epoch, added, removed)`` where replaying
        ``fp | added - removed`` onto the snapshot taken at ``since_epoch``
        reproduces :meth:`fingerprint` at the current epoch — the router's
        O(churn) alternative to a full frozenset snapshot every dispatch
        round. Returns ``None`` when ``since_epoch`` predates the journal
        (the consumer fell more than ``JOURNAL_DEPTH`` mutations behind, or
        claims an epoch from another cache's future): take a fresh snapshot.
        Add-then-remove pairs inside the window collapse to nothing, so the
        delta stays small however hot the churn.
        """
        if since_epoch > self.epoch or \
                since_epoch < self.epoch - len(self._journal):
            return None
        added: set = set()
        removed: set = set()
        for ep, sign, h in self._journal:
            if ep <= since_epoch:
                continue
            if sign > 0:
                if h in removed:
                    removed.discard(h)
                else:
                    added.add(h)
            else:
                if h in added:
                    added.discard(h)
                else:
                    removed.add(h)
        return self.epoch, frozenset(added), frozenset(removed)
