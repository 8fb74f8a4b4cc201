from .pipeline import PrefetchLoader, SyntheticCorpus, TokenLoader

__all__ = ["PrefetchLoader", "SyntheticCorpus", "TokenLoader"]
