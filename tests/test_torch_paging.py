"""The port's paging module (a numpy-only copy) behaves exactly like the
reference's: the allocator and radix-cache scenarios of the reference's
suite run on both modules, and one seeded random mix of allocations,
shares, releases, registrations, lookups and evictions yields identical
results, fingerprints and eviction events from both."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serve import paging as jpaging  # noqa: E402
from repro_torch.serve import paging as tpaging  # noqa: E402

MODULES = pytest.mark.parametrize("mod", [jpaging, tpaging],
                                  ids=["reference", "port"])


@MODULES
def test_allocator_share_revives_free_page(mod):
    al = mod.PageAllocator(5)                   # pages 1..4
    p = al.alloc()
    al.release(p)
    assert al.available() == 4
    al.share(p)                                 # cache hit on a retired page
    assert al.available() == 3
    got = {al.alloc() for _ in range(3)}        # stale free-list entry skipped
    assert p not in got
    with pytest.raises(RuntimeError, match="exhausted"):
        al.alloc()
    al.release(p)
    assert al.alloc() == p


@MODULES
def test_prefix_cache_lookup_register_evict(mod):
    pc = mod.PrefixCache(4)
    prompt = list(range(10))                    # 2 full pages + 2-token tail
    pc.register(prompt, [7, 8, 9])
    assert pc.lookup(prompt + [99]) == ([7, 8, 9], 10)
    assert pc.lookup(prompt[:6]) == ([7], 4)
    assert pc.lookup(prompt[:4] + [55, 56, 57, 58]) == ([7], 4)
    pc.evict(7)                                 # takes the chain + partial
    assert pc.lookup(prompt) == ([], 0)
    assert len(pc) == 0


@MODULES
def test_prefix_cache_namespaces_and_eviction_on_realloc(mod):
    al = mod.PageAllocator(5)
    pc = mod.PrefixCache(4)
    events = []
    pc.on_evict = events.append
    al.on_alloc = pc.evict
    prompt = list(range(8))
    pa = [al.alloc(), al.alloc()]
    pc.register(prompt, pa, namespace="tenant-a")
    pb = [al.alloc(), al.alloc()]
    pc.register(prompt, pb, namespace="tenant-b")
    assert pc.lookup(prompt) == ([], 0)         # default namespace: no hit
    for p in reversed(pa):
        al.release(p)
    assert pc.lookup(prompt, namespace="tenant-a") == (pa, 8)
    assert al.alloc() == pa[0]                  # LIFO reuse evicts the chain
    assert pc.lookup(prompt, namespace="tenant-a") == ([], 0)
    assert pc.lookup(prompt, namespace="tenant-b") == (pb, 8)
    assert [(e.pages, e.namespace) for e in events] == \
        [((pa[0], pa[1]), "tenant-a")]
    assert mod.chain_hashes(prompt, 4, "tenant-b")[-1] in pc.fingerprint()


def _random_scenario(mod, seed: int):
    """Apply one seeded operation mix; return everything observable."""
    rng = np.random.RandomState(seed)
    al = mod.PageAllocator(17)
    pc = mod.PrefixCache(4)
    events, trace = [], []
    pc.on_evict = lambda e: events.append((e.pages, e.namespace, e.epoch))
    al.on_alloc = pc.evict
    held: list[int] = []
    for _ in range(300):
        op = rng.randint(5)
        ns = ["a", "b", None][rng.randint(3)]
        prompt = rng.randint(0, 3, size=rng.randint(1, 14)).tolist()
        need = -(-len(prompt) // 4)
        if op == 0 and al.available() >= need:
            pages = [al.alloc() for _ in range(need)]
            held += pages
            pc.register(prompt, pages, ns)
            trace.append(("reg", pages))
        elif op == 1 and held:
            p = held.pop(rng.randint(len(held)))
            al.release(p)
            trace.append(("rel", p))
        elif op == 2:
            chain, n = pc.lookup(prompt, ns)
            for p in chain:
                al.share(p)
                held.append(p)
            trace.append(("hit", chain, n))
        elif op == 3:
            trace.append(("fp", sorted(pc.fingerprint()),
                          pc.fingerprint_delta(max(0, pc.epoch - 5))))
        else:
            trace.append(("len", len(pc), al.available(), al.refs.tolist()))
    return trace, events


def test_random_scenario_identical():
    for seed in range(3):
        assert _random_scenario(jpaging, seed) == \
            _random_scenario(tpaging, seed)
