from .admission import (AdmissionError, AdmissionPolicy, CostBudgetExceeded,
                        DeadlineCostPolicy, DeadlineInfeasible, FCFSPolicy,
                        JobState, PreemptCandidate, RetryBudgetExhausted,
                        ServeJob, ServiceModel, StorageBudgetExceeded)
from .drafting import build_ngram_draft
from .engine import (ContinuousBatchingEngine, EngineRequest, ExportReason,
                     PausedRequest, ServeEngine, ServeResult, ShippedKV)
from .kv_store import PageResidency, RestoreTicket, Tier, TieredKVStore
from .paging import EvictionEvent, PageAllocator, PrefixCache, chain_hashes
from .routing import (HEALTH_DEGRADED, HEALTH_QUARANTINED, HEALTH_UP,
                      FingerprintTracker, FleetRouter, ReplicaView,
                      RouteDecision)
from .telemetry import (LATENCY_BUCKETS_S, MetricsRegistry, RegistryDict,
                        parse_exposition)

__all__ = ["ContinuousBatchingEngine", "EngineRequest", "ServeEngine",
           "ServeResult", "PausedRequest", "ShippedKV", "ExportReason",
           "PageAllocator", "PrefixCache", "EvictionEvent", "chain_hashes",
           "build_ngram_draft", "FleetRouter", "ReplicaView",
           "RouteDecision", "FingerprintTracker", "HEALTH_UP",
           "HEALTH_DEGRADED", "HEALTH_QUARANTINED", "ServeJob", "JobState",
           "ServiceModel", "AdmissionPolicy", "FCFSPolicy",
           "DeadlineCostPolicy", "PreemptCandidate", "AdmissionError",
           "DeadlineInfeasible", "CostBudgetExceeded",
           "RetryBudgetExhausted", "StorageBudgetExceeded",
           "MetricsRegistry", "RegistryDict", "parse_exposition",
           "LATENCY_BUCKETS_S", "PageResidency", "RestoreTicket", "Tier",
           "TieredKVStore"]
