"""Open-loop trace-driven traffic generation for the serving gateway.

A closed-loop bench submits a few dozen requests, drains and measures.
Closed loops cannot find a saturation wall — completions
gate submissions, so offered load self-limits exactly when the system
starts to fall behind. This module generates **open-loop** traffic the way
the paper's Fig-6 experiment drives DynamoDB: arrivals are a function of
*virtual time only*, independent of completions, so overload actually
queues, sheds, and burns SLO — and "max sustained req/s at the 99%
deadline-hit bar" becomes measurable.

The arrival process models a large consumer population on a shared
platform (the "million users" the paper's GeoDeepDive/social-media
workloads imply):

- **Poisson arrivals with diurnal modulation** — a non-homogeneous Poisson
  process via Lewis thinning: base rate x ``(1 + amplitude *
  sin(2*pi*t/period))``, so a trace can sweep through its own peak.
- **Zipf-distributed users** mapped onto a fixed tenant set — a handful of
  heavy principals dominate, the long tail trickles, matching every
  production multi-tenant trace. ``users`` can be 10**6 without
  materializing anything per-user: user identity only seeds that
  request's unique prompt tail.
- **Shared prefixes** — each tenant has a hot prompt prefix (system
  prompt / dataset preamble) its requests share, which is what makes
  prefix caching and affinity routing matter under load.
- **Mixed classes** — interactive (priority 0, tight deadline) vs batch
  (priority 1, loose deadline) split by ``interactive_fraction``.
- **Session resumption** (``resume_fraction > 0``) — a fraction of
  requests come back after an exponential **cold gap**
  (``cold_gap_mean_s``): the resumed arrival replays the original prompt
  plus the assistant's reply plus a fresh user turn, which is exactly the
  traffic the tiered KV hierarchy exists for (the gap is long enough for
  the session's pages to have been demoted off the device).
  :func:`run_open_loop` splices the original request's actual emitted
  tokens into the resumed prompt at submit time, so the resumed stream
  token-identically extends the demoted one. A resume whose original is
  still in flight holds until the reply lands (a follow-up turn cannot
  precede the reply it quotes) — the one departure from pure open-loop
  arrivals, and the reason resumed prompts are identical across runs that
  differ only in service speed.

Determinism: everything derives from ``seed`` via ``numpy.random
.RandomState``; the same config always yields byte-identical traces, so
saturation numbers are comparable across hosts (the repo-wide virtual
clock discipline).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from .admission import JobState

__all__ = ["TrafficConfig", "Arrival", "generate_trace", "offered_load",
           "run_open_loop"]


@dataclass(frozen=True)
class TrafficConfig:
    """Knobs for one generated trace. Token ids stay inside
    ``vocab_size``; prompt lengths are ``prefix_tokens`` (shared, hot)
    plus a unique per-request tail of ``tail_tokens_min..max``."""

    duration_s: float = 30.0
    base_rate_rps: float = 4.0
    diurnal_amplitude: float = 0.0        # 0..1 of base rate
    diurnal_period_s: float = 60.0        # compressed "day" in sim seconds
    tenants: int = 4
    users: int = 1_000_000                # population behind the tenants
    zipf_alpha: float = 1.3               # >1; lower = heavier tail
    prefix_tokens: int = 16               # shared per-tenant hot prefix
    tail_tokens_min: int = 2
    tail_tokens_max: int = 8
    interactive_fraction: float = 0.5
    interactive_deadline_s: float = 8.0
    batch_deadline_s: float = 60.0
    interactive_max_new: int = 8
    batch_max_new: int = 8
    vocab_size: int = 256
    # Session resumption: a resumed arrival follows its original after an
    # exponential cold gap, carrying the original prompt plus a fresh
    # ``resume_tail_tokens``-token user turn. 0.0 keeps old traces
    # byte-identical (no extra rng draws happen).
    resume_fraction: float = 0.0
    cold_gap_mean_s: float = 30.0
    resume_tail_tokens: int = 4
    seed: int = 0


@dataclass(frozen=True)
class Arrival:
    """One request, fully determined at generation time."""

    at_s: float                 # absolute virtual arrival time
    tenant_idx: int             # 0..tenants-1 (caller maps to principals)
    user: int                   # Zipf-ranked user id behind the request
    prompt: tuple
    max_new: int
    deadline_s: float           # relative to arrival
    priority: int               # 0 interactive, 1 batch
    # Session linkage: resumes share a session id with their original.
    # ``prompt`` on a resumed arrival is original-prompt + fresh tail;
    # run_open_loop splices the original's emitted tokens in between.
    session: int = -1           # -1: not part of a resumed session
    resumed: bool = False


def _rate_at(cfg: TrafficConfig, t: float) -> float:
    return cfg.base_rate_rps * (1.0 + cfg.diurnal_amplitude
                                * math.sin(2.0 * math.pi * t
                                           / cfg.diurnal_period_s))


def _zipf_user(rng: np.random.RandomState, cfg: TrafficConfig) -> int:
    """Zipf-ranked user id in [0, users): rank 0 is the heaviest user.
    Rejection-sample numpy's unbounded Zipf down to the population."""
    while True:
        u = int(rng.zipf(cfg.zipf_alpha)) - 1
        if u < cfg.users:
            return u


def generate_trace(cfg: TrafficConfig) -> list[Arrival]:
    """The full arrival list for ``cfg``, sorted by time.

    Non-homogeneous Poisson via Lewis thinning: candidates arrive at the
    peak rate, and each survives with probability rate(t)/peak — exact for
    any bounded rate function, and O(peak x duration) cheap.
    """
    if cfg.diurnal_amplitude < 0 or cfg.diurnal_amplitude > 1:
        raise ValueError(f"diurnal_amplitude must be in [0, 1], got "
                         f"{cfg.diurnal_amplitude}")
    if cfg.zipf_alpha <= 1.0:
        raise ValueError(f"zipf_alpha must be > 1, got {cfg.zipf_alpha}")
    rng = np.random.RandomState(cfg.seed)
    # Per-tenant hot prefixes: deterministic, disjoint-ish token blocks.
    prefixes = [tuple(int(x) for x in
                      rng.randint(0, cfg.vocab_size, size=cfg.prefix_tokens))
                for _ in range(cfg.tenants)]
    peak = cfg.base_rate_rps * (1.0 + cfg.diurnal_amplitude)
    out: list[Arrival] = []
    next_session = 0
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / peak))
        if t >= cfg.duration_s:
            break
        if float(rng.uniform()) > _rate_at(cfg, t) / peak:
            continue                       # thinned candidate
        user = _zipf_user(rng, cfg)
        tenant = user % cfg.tenants
        ntail = int(rng.randint(cfg.tail_tokens_min,
                                cfg.tail_tokens_max + 1))
        # The tail is the user's own context: seeded by user id so repeat
        # visits from one user share MORE than the tenant prefix, while
        # two users never collide past it.
        tail_rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + user * 7919) % (2 ** 31))
        tail = tuple(int(x) for x in
                     tail_rng.randint(0, cfg.vocab_size, size=ntail))
        interactive = float(rng.uniform()) < cfg.interactive_fraction
        prompt = prefixes[tenant] + tail
        max_new = (cfg.interactive_max_new if interactive
                   else cfg.batch_max_new)
        deadline = (cfg.interactive_deadline_s if interactive
                    else cfg.batch_deadline_s)
        prio = 0 if interactive else 1
        session = -1
        resume: Optional[Arrival] = None
        # Guarded draws: with resume_fraction == 0 the rng stream is
        # untouched and pre-existing traces stay byte-identical.
        if cfg.resume_fraction > 0 and \
                float(rng.uniform()) < cfg.resume_fraction:
            session = next_session
            next_session += 1
            gap = float(rng.exponential(cfg.cold_gap_mean_s))
            rtail = tuple(int(x) for x in tail_rng.randint(
                0, cfg.vocab_size, size=cfg.resume_tail_tokens))
            resume = Arrival(
                at_s=t + gap, tenant_idx=tenant, user=user,
                prompt=prompt + rtail, max_new=max_new,
                deadline_s=deadline, priority=prio,
                session=session, resumed=True)
        out.append(Arrival(
            at_s=t, tenant_idx=tenant, user=user, prompt=prompt,
            max_new=max_new, deadline_s=deadline, priority=prio,
            session=session))
        if resume is not None:
            out.append(resume)
    out.sort(key=lambda a: a.at_s)     # resumes land out of order
    return out


def offered_load(trace: list[Arrival], cfg: TrafficConfig) -> float:
    return len(trace) / cfg.duration_s if cfg.duration_s else 0.0


def run_open_loop(gw, tokens: list, trace: list[Arrival], *,
                  max_rounds: int = 200_000,
                  on_submit: Optional[Callable] = None) -> int:
    """Drive ``gw`` through ``trace`` open-loop, then drain.

    ``tokens[i]`` is the session token for tenant index ``i``. Before each
    gateway round, every arrival whose virtual time has come is submitted —
    regardless of how far behind the fleet is (that is the whole point).
    Submission errors from admission shed paths do not exist here (``submit``
    only raises on authorization failure); shed happens inside ``step``.
    Returns the number of rounds stepped; raises if the trace + drain does
    not complete within ``max_rounds`` (a wedged gateway, not overload —
    overload resolves by shedding).
    """
    i = 0
    rounds = 0
    start = gw.clock.now()          # trace times are relative to run start
    sessions: dict[int, tuple] = {}    # session id -> (rid, orig prompt len)
    # Resumed arrivals whose original is still in flight: a follow-up turn
    # cannot precede the reply it quotes, so these hold until the original
    # reaches a terminal state (DONE -> splice the reply in; SHED -> resume
    # without it) and submit at the next round. Everything else stays pure
    # open-loop; with resume_fraction == 0 this pool is always empty.
    pending: list[Arrival] = []

    def _ready(a: Arrival) -> bool:
        if not a.resumed or a.session not in sessions:
            return True
        job = gw.jobs[sessions[a.session][0]]
        return job.status is JobState.DONE or job.status is JobState.SHED

    def _submit(a: Arrival) -> None:
        prompt = list(a.prompt)
        if a.resumed and a.session in sessions:
            # The resumed conversation includes the assistant's actual
            # reply: splice the original's emitted tokens between its
            # prompt and the fresh user turn.
            orid, plen = sessions[a.session]
            job = gw.jobs[orid]
            if job.tokens is not None:
                prompt = prompt[:plen] + list(job.tokens) + prompt[plen:]
        rid = gw.submit(tokens[a.tenant_idx], prompt,
                        max_new=a.max_new, deadline_s=a.deadline_s,
                        priority=a.priority)
        if a.session >= 0 and not a.resumed:
            sessions[a.session] = (rid, len(a.prompt))
        if on_submit is not None:
            on_submit(a, rid)

    while i < len(trace) or pending or gw.outstanding():
        now = gw.clock.now()
        for a in [a for a in pending if _ready(a)]:
            pending.remove(a)
            _submit(a)
        while i < len(trace) and start + trace[i].at_s <= now:
            a = trace[i]
            i += 1
            if _ready(a):
                _submit(a)
            else:
                pending.append(a)
        gw.step()
        rounds += 1
        if rounds > max_rounds:
            raise RuntimeError(
                f"open-loop run exceeded {max_rounds} rounds "
                f"({i}/{len(trace)} submitted, {len(pending)} pending, "
                f"{gw.outstanding()} outstanding)")
    return rounds
