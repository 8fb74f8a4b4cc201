from .drafting import build_ngram_draft
from .engine import (ContinuousBatchingEngine, EngineRequest, ServeEngine,
                     ServeResult)
from .paging import EvictionEvent, PageAllocator, PrefixCache, chain_hashes

__all__ = ["ContinuousBatchingEngine", "EngineRequest", "ServeEngine",
           "ServeResult",
           "PageAllocator", "PrefixCache", "EvictionEvent", "chain_hashes",
           "build_ngram_draft"]
