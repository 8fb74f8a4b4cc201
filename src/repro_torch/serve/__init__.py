from .drafting import build_ngram_draft
from .engine import ContinuousBatchingEngine, EngineRequest, ServeResult
from .paging import EvictionEvent, PageAllocator, PrefixCache, chain_hashes

__all__ = ["ContinuousBatchingEngine", "EngineRequest", "ServeResult",
           "PageAllocator", "PrefixCache", "EvictionEvent", "chain_hashes",
           "build_ngram_draft"]
