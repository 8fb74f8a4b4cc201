"""Control-plane pieces of the reference's ``repro.core`` that the port's
serve modules need, copied: ``cost`` (the pricing dataclasses)."""
from .cost import ComputePricing, StoragePricing

__all__ = ["ComputePricing", "StoragePricing"]
