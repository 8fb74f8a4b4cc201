"""Role-based security fabric (paper §VI).

Implements Cloud Kotta's security model:

- **Principals** authenticate (the paper delegates to Login-with-Amazon OAuth2;
  here, a pluggable ``Authenticator``) and receive **short-term session
  tokens** (1 h API tokens, 6 h web sessions).
- **Roles** carry **policies** (allow/deny on action+resource glob patterns).
  Every principal starts with *no* privileges (least privilege) and is
  incrementally granted roles.
- **Trusted roles** (e.g. ``task-executor``) may **assume** user roles to stage
  that user's data, then revert — exactly the worker-node dance in §VI.
- **Signed URLs** give short-term, capability-style read access (the paper's
  DropBox-like sharing links).
- Every authorization decision is appended to an immutable **audit log**
  (paper: "CLOUD KOTTA tracks all data access by users and analyses").
"""
from __future__ import annotations

import fnmatch
import hashlib
import hmac
import secrets
from dataclasses import dataclass, field
from typing import Iterable, Optional

from .clock import Clock, hours

API_TOKEN_LIFETIME_S = hours(1)   # paper: delegated token valid for one hour
WEB_SESSION_LIFETIME_S = hours(6)  # paper: web sessions valid for six hours


class SecurityError(Exception):
    """Base class for authn/authz failures."""


class AuthenticationError(SecurityError):
    pass


class AuthorizationError(SecurityError):
    pass


class TokenExpiredError(SecurityError):
    pass


@dataclass(frozen=True)
class Principal:
    principal_id: str
    display_name: str = ""


@dataclass(frozen=True)
class Policy:
    """IAM-style statement: effect on (actions × resources) glob patterns."""

    effect: str                 # "allow" | "deny"
    actions: tuple[str, ...]    # e.g. ("data:Get", "data:Put", "jobs:*")
    resources: tuple[str, ...]  # e.g. ("dataset/wos/*",)

    def __post_init__(self):
        if self.effect not in ("allow", "deny"):
            raise ValueError(f"bad effect {self.effect!r}")

    def matches(self, action: str, resource: str) -> bool:
        return any(fnmatch.fnmatchcase(action, a) for a in self.actions) and any(
            fnmatch.fnmatchcase(resource, r) for r in self.resources
        )


def allow(actions: Iterable[str], resources: Iterable[str]) -> Policy:
    return Policy("allow", tuple(actions), tuple(resources))


def deny(actions: Iterable[str], resources: Iterable[str]) -> Policy:
    return Policy("deny", tuple(actions), tuple(resources))


@dataclass
class Role:
    """A named bundle of policies.

    ``trusted_assumers``: role names allowed to ``assume_role`` into this role
    (the paper's *task-executor* is trusted to assume user roles while staging
    that user's data).
    ``internal``: internal service roles (web-server, task-executor,
    queue-watcher) that may touch the database/queues/scaling controls.
    """

    name: str
    policies: list[Policy] = field(default_factory=list)
    trusted_assumers: set[str] = field(default_factory=set)
    internal: bool = False


@dataclass(frozen=True)
class SessionToken:
    token_id: str
    principal_id: str
    role_name: str
    issued_at: float
    expires_at: float
    parent_token_id: Optional[str] = None  # set for assumed-role sessions


@dataclass(frozen=True)
class AuditRecord:
    timestamp: float
    principal_id: str
    role_name: str
    action: str
    resource: str
    decision: str   # "allow" | "deny"
    detail: str = ""


class AuditLog:
    """Append-only audit trail with simple query support."""

    def __init__(self):
        self._records: list[AuditRecord] = []

    def append(self, rec: AuditRecord) -> None:
        self._records.append(rec)

    def records(
        self,
        principal_id: str | None = None,
        resource_glob: str | None = None,
        decision: str | None = None,
    ) -> list[AuditRecord]:
        out = self._records
        if principal_id is not None:
            out = [r for r in out if r.principal_id == principal_id]
        if resource_glob is not None:
            out = [r for r in out if fnmatch.fnmatchcase(r.resource, resource_glob)]
        if decision is not None:
            out = [r for r in out if r.decision == decision]
        return list(out)

    def __len__(self) -> int:
        return len(self._records)


class Authenticator:
    """Pluggable identity provider (paper: Login with Amazon / OAuth2).

    The default implementation holds a registry of known identities and their
    shared secrets — sufficient to model the redirect/token exchange without a
    network. ``authenticate`` returns the principal on success.
    """

    def __init__(self):
        self._secrets: dict[str, str] = {}
        self._principals: dict[str, Principal] = {}

    def register_identity(self, principal: Principal, secret: str) -> None:
        self._principals[principal.principal_id] = principal
        self._secrets[principal.principal_id] = secret

    def authenticate(self, principal_id: str, secret: str) -> Principal:
        expected = self._secrets.get(principal_id)
        if expected is None or not hmac.compare_digest(expected, secret):
            raise AuthenticationError(f"authentication failed for {principal_id!r}")
        return self._principals[principal_id]


class PolicyEngine:
    """The security fabric: roles, bindings, sessions, authorization, audit."""

    def __init__(self, clock: Clock | None = None, signing_key: bytes | None = None):
        self.clock = clock or Clock()
        self.audit = AuditLog()
        self.authenticator = Authenticator()
        self._roles: dict[str, Role] = {}
        self._bindings: dict[str, set[str]] = {}  # principal -> role names
        self._sessions: dict[str, SessionToken] = {}
        self._signing_key = signing_key or secrets.token_bytes(32)

    # -- administration -------------------------------------------------
    def register_role(self, role: Role) -> Role:
        if role.name in self._roles:
            raise ValueError(f"role {role.name!r} already registered")
        self._roles[role.name] = role
        return role

    def bind(self, principal: Principal, role_name: str) -> None:
        """Grant ``role_name`` to ``principal`` (incremental, least privilege)."""
        if role_name not in self._roles:
            raise KeyError(f"unknown role {role_name!r}")
        self._bindings.setdefault(principal.principal_id, set()).add(role_name)

    def unbind(self, principal: Principal, role_name: str) -> None:
        self._bindings.get(principal.principal_id, set()).discard(role_name)

    def roles_of(self, principal_id: str) -> set[str]:
        return set(self._bindings.get(principal_id, set()))

    # -- authentication / sessions --------------------------------------
    def login(
        self, principal_id: str, secret: str, role_name: str | None = None,
        lifetime_s: float = API_TOKEN_LIFETIME_S,
    ) -> SessionToken:
        """OAuth2-style exchange: credentials -> short-term delegated token."""
        principal = self.authenticator.authenticate(principal_id, secret)
        granted = self.roles_of(principal.principal_id)
        if role_name is None:
            if not granted:
                raise AuthorizationError(
                    f"{principal_id!r} has no roles (least privilege default)")
            role_name = sorted(granted)[0]
        if role_name not in granted:
            raise AuthorizationError(f"{principal_id!r} is not bound to {role_name!r}")
        return self._issue(principal.principal_id, role_name, lifetime_s)

    def web_session(self, principal_id: str, secret: str) -> SessionToken:
        """Paper: web interface translates tokens into 6-hour sessions."""
        return self.login(principal_id, secret, lifetime_s=WEB_SESSION_LIFETIME_S)

    def service_session(self, role_name: str) -> SessionToken:
        """Bootstrap a session for an *internal* service role."""
        role = self._roles.get(role_name)
        if role is None or not role.internal:
            raise AuthorizationError(f"{role_name!r} is not an internal service role")
        return self._issue(f"service:{role_name}", role_name, WEB_SESSION_LIFETIME_S)

    def _issue(self, principal_id: str, role_name: str, lifetime_s: float,
               parent: str | None = None) -> SessionToken:
        now = self.clock.now()
        tok = SessionToken(
            token_id=secrets.token_hex(16),
            principal_id=principal_id,
            role_name=role_name,
            issued_at=now,
            expires_at=now + lifetime_s,
            parent_token_id=parent,
        )
        self._sessions[tok.token_id] = tok
        return tok

    def _validate(self, token: SessionToken) -> SessionToken:
        live = self._sessions.get(token.token_id)
        if live is None or live != token:
            raise AuthenticationError("unknown or revoked token")
        if self.clock.now() >= token.expires_at:
            raise TokenExpiredError(f"token for {token.principal_id} expired")
        return token

    def revoke(self, token: SessionToken) -> None:
        self._sessions.pop(token.token_id, None)

    # -- role assumption (paper §VI worker dance) ------------------------
    def assume_role(self, token: SessionToken, target_role: str,
                    lifetime_s: float = API_TOKEN_LIFETIME_S) -> SessionToken:
        """Switch to ``target_role`` if the current role is trusted to do so."""
        self._validate(token)
        target = self._roles.get(target_role)
        if target is None:
            raise KeyError(f"unknown role {target_role!r}")
        current = token.role_name
        bound = target_role in self.roles_of(token.principal_id)
        trusted = current in target.trusted_assumers
        if not (bound or trusted):
            self.audit.append(AuditRecord(
                self.clock.now(), token.principal_id, current,
                "sts:AssumeRole", f"role/{target_role}", "deny"))
            raise AuthorizationError(
                f"role {current!r} may not assume {target_role!r}")
        self.audit.append(AuditRecord(
            self.clock.now(), token.principal_id, current,
            "sts:AssumeRole", f"role/{target_role}", "allow"))
        lifetime = min(lifetime_s, token.expires_at - self.clock.now())
        return self._issue(token.principal_id, target_role, lifetime,
                           parent=token.token_id)

    # -- authorization ---------------------------------------------------
    def is_authorized(self, token: SessionToken, action: str, resource: str) -> bool:
        try:
            self.check(token, action, resource)
            return True
        except SecurityError:
            return False

    def check(self, token: SessionToken, action: str, resource: str) -> None:
        """Default-deny; explicit deny beats allow. Raises on failure."""
        self._validate(token)
        role = self._roles.get(token.role_name)
        decision = "deny"
        if role is not None:
            matches = [p for p in role.policies if p.matches(action, resource)]
            if matches and not any(p.effect == "deny" for p in matches):
                decision = "allow"
        self.audit.append(AuditRecord(
            self.clock.now(), token.principal_id, token.role_name,
            action, resource, decision))
        if decision != "allow":
            raise AuthorizationError(
                f"{token.principal_id} ({token.role_name}) denied {action} on {resource}")

    # -- signed URLs -------------------------------------------------------
    def sign_url(self, token: SessionToken, resource: str,
                 lifetime_s: float = API_TOKEN_LIFETIME_S) -> str:
        """Short-term capability link for sharing a single object (paper §VI)."""
        self.check(token, "data:Share", resource)
        expires = int(self.clock.now() + lifetime_s)
        msg = f"{resource}|{expires}".encode()
        sig = hmac.new(self._signing_key, msg, hashlib.sha256).hexdigest()
        return f"kotta://{resource}?expires={expires}&sig={sig}"

    def verify_url(self, url: str) -> str:
        """Return the resource if the signed URL is intact and unexpired."""
        if not url.startswith("kotta://"):
            raise AuthorizationError("not a kotta signed URL")
        body = url[len("kotta://"):]
        resource, _, query = body.partition("?")
        params = dict(kv.split("=", 1) for kv in query.split("&") if "=" in kv)
        try:
            expires = int(params["expires"])
            sig = params["sig"]
        except (KeyError, ValueError) as e:
            raise AuthorizationError("malformed signed URL") from e
        msg = f"{resource}|{expires}".encode()
        want = hmac.new(self._signing_key, msg, hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, sig):
            raise AuthorizationError("signature mismatch")
        if self.clock.now() >= expires:
            raise TokenExpiredError("signed URL expired")
        return resource


# ---------------------------------------------------------------------------
# Standard Kotta deployment roles (paper Fig 3)
# ---------------------------------------------------------------------------

def install_standard_roles(engine: PolicyEngine) -> dict[str, Role]:
    """Register the paper's predefined roles and return them by name."""
    roles = {
        "kotta-public-only": Role(
            "kotta-public-only",
            policies=[allow(["data:Get", "data:List"], ["dataset/public/*"])],
        ),
        "web-server": Role(
            "web-server",
            policies=[
                allow(["db:*", "queue:Put", "queue:List", "jobs:*"], ["*"]),
                allow(["data:List"], ["dataset/*"]),
            ],
            internal=True,
        ),
        "task-executor": Role(
            "task-executor",
            policies=[
                allow(["db:Get", "db:Put", "queue:Get", "queue:Ack", "queue:Put"], ["*"]),
                allow(["data:Get", "data:Put"], ["results/*", "scratch/*"]),
                allow(["scale:Report"], ["pool/*"]),
            ],
            internal=True,
        ),
        "queue-watcher": Role(
            "queue-watcher",
            policies=[
                allow(["db:*", "queue:*", "scale:*"], ["*"]),
            ],
            internal=True,
        ),
    }
    for r in roles.values():
        engine.register_role(r)
    return roles


def make_dataset_role(engine: PolicyEngine, dataset: str,
                      downloadable: bool = False) -> Role:
    """Create the paper's ``kotta-read-<DS>-private`` style role.

    Non-downloadable datasets are readable only by compute (the worker's
    assumed role), mirroring the paper's "read-only access to specified
    compute nodes" bucket policies: the role is granted ``data:Get`` but a
    explicit deny on ``data:Download`` keeps bytes inside the enclave.
    """
    policies = [allow(["data:Get", "data:List"], [f"dataset/{dataset}/*"])]
    if downloadable:
        policies.append(allow(["data:Download", "data:Share"], [f"dataset/{dataset}/*"]))
    else:
        policies.append(deny(["data:Download"], [f"dataset/{dataset}/*"]))
    role = Role(f"kotta-read-{dataset}-private", policies=policies,
                trusted_assumers={"task-executor"})
    engine.register_role(role)
    return role


def make_serving_role(engine: PolicyEngine, tenant: str,
                      models: Iterable[str] = ("serve",),
                      data_zones: Iterable[str] = ()) -> Role:
    """Per-tenant serving-gateway role: ``kotta-serve-<tenant>``.

    Grants ``serve:Generate`` on the named model resources and ``data:Get``
    on the tenant's data zones (the prompt-context datasets the gateway
    checks at submit). Principals without this role are denied at the
    gateway — default-deny, with the deny audit-logged — and the gateway
    additionally namespaces the KV prefix cache by (tenant principal,
    data-zone), so authorization and cache isolation share one boundary.
    """
    policies = [allow(["serve:Generate"], [f"model/{m}" for m in models])]
    zones = tuple(data_zones)
    if zones:
        policies.append(allow(["data:Get"],
                              [f"dataset/{z}/*" for z in zones]))
    role = Role(f"kotta-serve-{tenant}", policies=policies)
    engine.register_role(role)
    return role


def provision_tenant(engine: PolicyEngine, tenant: str, secret: str,
                     models: Iterable[str] = ("serve",),
                     data_zones: Iterable[str] = ()) -> SessionToken:
    """Register a serving tenant end to end and return a live session.

    One call covers the identity + role + binding + login dance the
    gateway's launcher, benchmark and tests all need: the principal is
    registered with ``secret``, granted a fresh ``kotta-serve-<tenant>``
    role (see :func:`make_serving_role`), and logged in.
    """
    principal = Principal(tenant)
    engine.authenticator.register_identity(principal, secret)
    role = make_serving_role(engine, tenant, models=models,
                             data_zones=data_zones)
    engine.bind(principal, role.name)
    return engine.login(tenant, secret)
