"""Kotta core, copied from the reference's ``repro.core``: the paper's
contributions as composable components.

- :mod:`repro_torch.core.clock`     — wall and virtual clocks
- :mod:`repro_torch.core.security`  — RBAC fabric, assume-role, signed URLs,
  audit (§VI)
- :mod:`repro_torch.core.lifecycle` — tiered object store + LRU lifecycle
  (§V-A), which the trainer's data and checkpoints live in
- :mod:`repro_torch.core.cost`      — storage / compute / placement cost
  models (§V, §VII)
- :mod:`repro_torch.core.market`    — spot price traces + revocation (§IV-C)
- :mod:`repro_torch.core.placement` — cost-aware placement (§VII-E)
- :mod:`repro_torch.core.scheduler` — StateStore, queues, workers,
  queue-watcher, ``KottaService`` (§IV-D)
- :mod:`repro_torch.core.elastic`   — scaling policies / provisioner (§V-B)
- :mod:`repro_torch.core.simulator` — discrete-event reproduction of §VII-C

The reference's TPU roofline constants (``TpuChipSpec``, ``TPU_V5E``) are
not copied; ``cost.H100_SXM`` gives the dry-run the card's peak figures.
"""
from .clock import Clock, VirtualClock, days, hours
from .cost import (H100_SXM, ComputePricing, GpuChipSpec, StoragePricing,
                   lifecycle_annual_cost, placement_cost)
from .lifecycle import (DEFAULT_POLICY, LifecyclePolicy, ObjectArchivedError,
                        ObjectNotFoundError, ObjectStore, SecureStorage,
                        StorageError, Tier)
from .elastic import Provisioner, ProvisioningModel, ScalingPolicy
from .market import DEFAULT_ZONES, AvailabilityZone, SpotMarket
from .placement import PlacementDecision, PlacementPolicy
from .scheduler import (ExecutableRegistry, JobContext, JobQueue, JobSpec,
                        JobStatus, KottaService, ShardedStateStore,
                        StateStore, Worker)
from .security import (AuditLog, AuditRecord, AuthenticationError,
                       AuthorizationError, Policy,
                       PolicyEngine, Principal, Role, SecurityError,
                       SessionToken, TokenExpiredError, allow, deny,
                       install_standard_roles, make_dataset_role,
                       make_serving_role, provision_tenant)
from .simulator import (ElasticSimulator, SimJob, SimReport,
                        make_paper_workload, run_table7c)

__all__ = [k for k in dir() if not k.startswith("_")]
