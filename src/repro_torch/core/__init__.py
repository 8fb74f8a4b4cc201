"""Control-plane pieces of the reference's ``repro.core`` that the port's
serve and train modules need, copied:

- :mod:`repro_torch.core.clock`     — wall and virtual clocks
- :mod:`repro_torch.core.security`  — RBAC fabric, session tokens, audit (§VI)
- :mod:`repro_torch.core.cost`      — storage / compute pricing (§V, §VII)
- :mod:`repro_torch.core.market`    — spot price traces + revocation (§IV-C)
- :mod:`repro_torch.core.elastic`   — scaling policies / provisioner (§V-B)
- :mod:`repro_torch.core.scheduler` — the provisioned StateStore (§IV-D)
- :mod:`repro_torch.core.lifecycle` — the tiered object store (§V-A), which
  the trainer's data and checkpoints live in
"""
from .clock import Clock, VirtualClock, days, hours
from .cost import ComputePricing, StoragePricing
from .lifecycle import (DEFAULT_POLICY, LifecyclePolicy, ObjectArchivedError,
                        ObjectNotFoundError, ObjectStore, SecureStorage,
                        StorageError, Tier)
from .elastic import Provisioner, ProvisioningModel, ScalingPolicy
from .market import DEFAULT_ZONES, AvailabilityZone, SpotMarket
from .scheduler import ShardedStateStore, StateStore
from .security import (AuditLog, AuditRecord, AuthenticationError,
                       AuthorizationError, Policy,
                       PolicyEngine, Principal, Role, SecurityError,
                       SessionToken, TokenExpiredError, allow, deny,
                       install_standard_roles, make_dataset_role,
                       make_serving_role, provision_tenant)

__all__ = [k for k in dir() if not k.startswith("_")]
