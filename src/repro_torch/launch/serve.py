"""Serving launcher: greedy decode of a reduced model, directly or through
the Kotta serving gateway.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --batch 4 --max-new 16 [--spec [--adaptive-k]] [--kv-dtype int8] \\
        [--prefill-mode dense] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --engine static --batch 4 --max-new 8 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \\
        --batch 4 --max-new 8 [--device cpu]

``--arch`` takes every config of the port: the dense transformers yi-6b,
internlm2-1.8b, mistral-nemo-12b and starcoder2-7b, the MoE transformers
olmoe-1b-7b and arctic-480b, the Zamba2 hybrid and xLSTM. ``--engine auto``
(the default) picks the continuous-batching engine for a family with a
paged decode path (every transformer, with or without experts) and the
static ``ServeEngine`` otherwise (Zamba2, xLSTM). ``--prefill-mode dense``
admits prompts to the continuous engine by ragged dense prefill instead of paged
chunks (no prefix cache, no int8 pool). Weights are random, drawn on the device from seed 0;
prompts from seed 1. Prints ``engine: <kind> (<device>)`` and then
``prompt -> tokens`` lines. The default device is ``cuda``, which fails
without a GPU: pass ``--device cpu`` to run the plain PyTorch path.

Gateway mode
------------
``--gateway`` routes every request through
:class:`~repro_torch.serve.gateway.KottaServeGateway` instead of calling
the engine directly, so each prompt becomes a secured, scheduled Kotta
job. The modes and their flags are the reference launcher's:

- ``--tenants N`` registers N tenant principals (``tenant0..``); requests
  round-robin across them and the prefix cache is namespaced per (tenant,
  data zone). ``--deadline-s S`` gives each request a deadline (EDF
  admission, infeasible requests shed with a typed rejection).
  ``--replicas R`` sizes a static on-demand fleet.
- ``--routing affinity|least-loaded|blind`` picks the fleet placement
  policy and gives every tenant a hot shared prefix;
  ``--disaggregate N_PREFILL:N_DECODE`` splits the fleet into prefill and
  decode replicas, with KV pages shipped per request.
- ``--interactive-burst``: batch jobs hold every decode slot, then a
  tight-deadline interactive burst preempts them (``--no-preempt`` sheds
  it instead; the default follows ``enable_decode_preemption``).
- ``--chaos-seed SEED``: a seeded fault storm (crashes, revocation notices
  answered by KV evacuation, stragglers, heartbeat loss); every job ends
  DONE or typed-SHED.
- ``--saturation``: open-loop Poisson/diurnal Zipf traffic, telemetry
  streamed into a write-capped ``StateStore``.
- ``--metrics-out PATH`` (any gateway mode) writes the final Prometheus
  text exposition.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --gateway --tenants 2 --deadline-s 200 --batch 5 --max-new 8
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from repro_torch.configs import ARCH_NAMES, get_reduced_config
from repro_torch.models import get_family, init_params
from repro_torch.serve import ContinuousBatchingEngine, ServeEngine


def _demo_prompts(cfg, batch: int) -> list[list[int]]:
    rng = np.random.RandomState(1)
    return [rng.randint(0, cfg.vocab_size, size=3 + i % 4).tolist()
            for i in range(batch)]


def _run_gateway(cfg, params, args):
    from repro_torch.core.elastic import ScalingPolicy
    from repro_torch.core.security import PolicyEngine, provision_tenant
    from repro_torch.core.clock import VirtualClock
    from repro_torch.serve import (DeadlineCostPolicy, JobState, KottaServeGateway,
                             ServiceModel)

    sec = PolicyEngine(clock=VirtualClock())
    tokens = [provision_tenant(sec, f"tenant{i}", f"pw-tenant{i}",
                               data_zones=("public",))
              for i in range(args.tenants)]

    # The policy estimates with the same model the gateway bills with; the
    # config knob decides whether infeasible interactive requests may pause
    # a batch-class slot instead of being shed.
    svc = ServiceModel()
    routing = (args.routing or "affinity").replace("-", "_")

    def factory(**kw):
        kw.setdefault("max_len", args.max_len)
        return lambda: ContinuousBatchingEngine(
            cfg, params, enable_spec_decode=args.spec,
            kv_cache_dtype=args.kv_dtype,
            spec_adaptive_k=args.adaptive_k or None, device=args.device,
            **kw)

    if args.disaggregate:
        n_prefill, n_decode = args.disaggregate
        gw = KottaServeGateway(
            factory(role="decode"), sec,
            scaling=ScalingPolicy.none(n_decode, market="on_demand"),
            service_model=svc, routing=routing,
            prefill_replicas=n_prefill,
            prefill_engine_factory=factory(role="prefill"),
            admission=DeadlineCostPolicy(
                model=svc, preempt=cfg.enable_decode_preemption))
        fleet_desc = f"{n_prefill} prefill + {n_decode} decode replica(s)"
    else:
        gw = KottaServeGateway(
            factory(), sec,
            scaling=ScalingPolicy.none(args.replicas, market="on_demand"),
            service_model=svc, routing=routing,
            admission=DeadlineCostPolicy(
                model=svc, preempt=cfg.enable_decode_preemption))
        fleet_desc = f"{args.replicas} static replica(s)"
    prompts = _demo_prompts(cfg, args.batch)
    if args.routing is not None or args.disaggregate:
        # Give each tenant a hot 2-page prefix so the routing/shipping
        # demo has cache residency to exploit (and to show in the stats).
        ps = cfg.page_size
        prompts = [[(17 + 31 * (i % len(tokens)) + j) % cfg.vocab_size
                    for j in range(2 * ps)] + p
                   for i, p in enumerate(prompts)]
    rids = []
    if args.routing is not None or args.disaggregate:
        # Two waves: the first warms each tenant's prefix onto a replica,
        # then the router places the rest against live fingerprints —
        # submitted all at once, nothing would have residency to hit.
        for wave in (prompts[:len(tokens)], prompts[len(tokens):]):
            rids += [gw.submit(tokens[(len(rids) + i) % len(tokens)], p,
                               max_new=args.max_new,
                               deadline_s=args.deadline_s,
                               data_zone="public")
                     for i, p in enumerate(wave)]
            gw.drain()
    else:
        rids = [gw.submit(tokens[i % len(tokens)], p, max_new=args.max_new,
                          deadline_s=args.deadline_s, data_zone="public")
                for i, p in enumerate(prompts)]
        gw.drain()
    print(f"engine: gateway ({fleet_desc}, "
          f"{args.tenants} tenant(s), routing={routing}) ({args.device})")
    for i, (p, rid) in enumerate(zip(prompts, rids)):
        job = gw.jobs[rid]
        if job.status is JobState.DONE:
            print(f"[{job.tenant}] {p} -> {job.tokens}")
        else:
            print(f"[{job.tenant}] {p} -> SHED ({job.error.reason}: "
                  f"{job.error})")
    m = gw.metrics()
    audit = sec.audit
    print(f"deadline hit rate {m['deadline_hit_rate']:.2f}   shed "
          f"{m['shed']}   audit: {len(audit.records(decision='allow'))} "
          f"allows / {len(audit.records(decision='deny'))} denies")
    if args.routing is not None or args.disaggregate:
        print(f"routing decisions: {m['routing']}")
        if m["page_ships"]:
            print(f"page shipping: {m['page_ships']} ships, "
                  f"{m['page_ship_bytes_per_ship'] / 1e6:.2f} MB/ship")
        for e in m["per_replica"]:
            print(f"  replica {e['replica']} ({e['role']}): dispatched "
                  f"{e['dispatched']}, prefix hit rate "
                  f"{e['prefix_hit_rate']:.1%}")
    return gw


def _run_interactive_burst(cfg, params, args):
    """Demo: decode preemption under a tight-deadline interactive burst."""
    from repro_torch.core.elastic import ScalingPolicy
    from repro_torch.core.security import PolicyEngine, provision_tenant
    from repro_torch.core.clock import VirtualClock
    from repro_torch.serve import (ContinuousBatchingEngine, DeadlineCostPolicy,
                             JobState, KottaServeGateway, ServiceModel)

    preempt_on = cfg.enable_decode_preemption and not args.no_preempt
    sec = PolicyEngine(clock=VirtualClock())
    tok = provision_tenant(sec, "tenant0", "pw-tenant0",
                           data_zones=("public",))
    svc = ServiceModel()
    slots = 4
    gw = KottaServeGateway(
        lambda: ContinuousBatchingEngine(
            cfg, params, max_len=args.max_len, max_slots=slots,
            num_pages=2 * slots * (args.max_len // cfg.page_size),
            decode_chunk=2, kv_cache_dtype=args.kv_dtype,
            device=args.device),
        sec, scaling=ScalingPolicy.none(args.replicas, market="on_demand"),
        service_model=svc,
        admission=DeadlineCostPolicy(model=svc, preempt=preempt_on))
    rng = np.random.RandomState(2)
    batch_rids = [gw.submit(
        tok, rng.randint(0, cfg.vocab_size, size=8).tolist(),
        max_new=32, deadline_s=3600.0, priority=1, data_zone="public")
        for i in range(slots)]
    # Let the batch occupy every slot, then fire the interactive burst.
    for _ in range(10_000):
        if any(l.emitted > 0 for r in gw.replicas()
               for l in r.engine._live.values()):
            break
        gw.step()
    else:
        raise SystemExit("interactive-burst demo: batch jobs never started "
                         "decoding (no live replica?)")
    inter_rids = [gw.submit(
        tok, rng.randint(0, cfg.vocab_size, size=6).tolist(),
        max_new=4, deadline_s=0.5, priority=0, data_zone="public")
        for i in range(3)]
    gw.drain()
    m = gw.metrics()
    print(f"engine: gateway interactive-burst demo (preemption "
          f"{'ON' if preempt_on else 'OFF'}; {slots} slots, "
          f"{len(batch_rids)} batch jobs, {len(inter_rids)} interactive) "
          f"({args.device})")
    for rid in inter_rids:
        job = gw.jobs[rid]
        if job.status is JobState.DONE:
            print(f"  interactive job {rid}: DONE ttft="
                  f"{job.started_at - job.submitted_at:.2f}s -> {job.tokens}")
        else:
            print(f"  interactive job {rid}: SHED ({job.error.reason})")
    print(f"preemptions {m['preemptions']}   resumes {m['resumes']}   "
          f"added batch wait {m['preempt_wait_s']:.2f}s   interactive p99 "
          f"TTFT {m['interactive_p99_ttft_s']:.2f}s   deadline hit rate "
          f"{m['deadline_hit_rate']:.2f}   shed {m['shed']}")
    audit = sec.audit.records()
    print(f"audit: {len([r for r in audit if r.action == 'serve:Preempt'])} "
          f"preempt / {len([r for r in audit if r.action == 'serve:Resume'])}"
          f" resume records")
    return gw


def _run_chaos(cfg, params, args):
    """Demo: a seeded fault storm over the fleet — crashes, revocation
    notices (KV evacuation), stragglers, heartbeat loss — with every job
    finishing or shedding with a typed error."""
    from collections import Counter

    from repro_torch.core.clock import VirtualClock
    from repro_torch.core.elastic import ProvisioningModel, ScalingPolicy
    from repro_torch.core.security import PolicyEngine, provision_tenant
    from repro_torch.serve import (ContinuousBatchingEngine, FaultInjector,
                             JobState, KottaServeGateway, ServiceModel)

    sec = PolicyEngine(clock=VirtualClock())
    tok = provision_tenant(sec, "tenant0", "pw-tenant0",
                           data_zones=("public",))
    horizon = 8.0
    inj = FaultInjector.random(
        args.chaos_seed, horizon, crash_rate_h=900.0, revoke_rate_h=1800.0,
        straggler_rate_h=1800.0, heartbeat_loss_rate_h=900.0,
        notice_s=0.6, duration_s=(0.5, 2.0), magnitude=(2.0, 6.0),
        max_targets=4)
    gw = KottaServeGateway(
        lambda: ContinuousBatchingEngine(cfg, params, max_len=args.max_len,
                                         decode_chunk=2,
                                         kv_cache_dtype=args.kv_dtype,
                                         device=args.device),
        sec,
        scaling=ScalingPolicy.none(max(2, args.replicas),
                                   market="on_demand"),
        provisioning=ProvisioningModel(base_delay_s=0.5, jitter_s=0.0,
                                       volatility_prob=0.0),
        service_model=ServiceModel(), retry_budget=8, backoff_base_s=0.5,
        fault_injector=inj)
    prompts = _demo_prompts(cfg, args.batch)
    rids = [gw.submit(tok, p, max_new=args.max_new, data_zone="public")
            for p in prompts]
    gw.drain(max_rounds=100_000)
    while gw.clock.now() < horizon + 1.0:   # let late-scheduled faults land
        gw.step()
    print(f"engine: gateway chaos demo (seed {args.chaos_seed}, "
          f"{inj.pending} pending / {len(inj.fired)} fired / "
          f"{len(inj.skipped)} skipped faults: "
          f"{dict(Counter(e.kind for e in inj.fired))}) ({args.device})")
    for rid in rids:
        job = gw.jobs[rid]
        if job.status is JobState.DONE:
            note = (f" ({job.evacuations} evac, {job.retries} retries)"
                    if job.disturbed_at is not None else "")
            print(f"  job {rid}: DONE{note} -> {job.tokens}")
        else:
            print(f"  job {rid}: SHED ({job.error.reason})")
    m = gw.metrics()
    print(f"notices {m['notices']}   evacuations {m['evacuations']} "
          f"({m['evacuated_pages_bytes'] / 1e6:.2f} MB)   requeues "
          f"{m['requeues']}   retries {m['retries']}   wasted decode "
          f"tokens {m['wasted_decode_tokens']}")
    if m["recovered_jobs"]:
        print(f"recovered TTFT mean {m['recovered_ttft_mean_s']:.2f}s over "
              f"{m['recovered_jobs']} disturbed job(s)   replica health "
              f"{m['replica_health']}")
    return gw


def _run_saturation(cfg, params, args):
    """Demo: open-loop Poisson/diurnal traffic from a Zipf-ranked user
    population, telemetry (audit + job records + metric snapshots)
    streaming into a write-capped StateStore while the fleet serves."""
    from repro_torch.core.clock import VirtualClock
    from repro_torch.core.elastic import ScalingPolicy
    from repro_torch.core.scheduler import StateStore
    from repro_torch.core.security import PolicyEngine, provision_tenant
    from repro_torch.serve import (ContinuousBatchingEngine, DeadlineCostPolicy,
                             KottaServeGateway, ServiceModel, TrafficConfig,
                             generate_trace, run_open_loop)
    from repro_torch.serve.loadgen import offered_load

    sec = PolicyEngine(clock=VirtualClock())
    tokens = [provision_tenant(sec, f"tenant{i}", f"pw-tenant{i}",
                               data_zones=("public",))
              for i in range(args.tenants)]
    svc = ServiceModel()
    store = StateStore(clock=sec.clock, write_capacity=50.0)
    gw = KottaServeGateway(
        lambda: ContinuousBatchingEngine(cfg, params, max_len=args.max_len,
                                         kv_cache_dtype=args.kv_dtype,
                                         device=args.device),
        sec, scaling=ScalingPolicy.none(args.replicas, market="on_demand"),
        service_model=svc, admission=DeadlineCostPolicy(model=svc),
        idle_tick_s=0.05, telemetry_store=store, telemetry_flush_s=2.0)
    duration_s = 10.0
    tc = TrafficConfig(
        duration_s=duration_s, base_rate_rps=8.0, diurnal_amplitude=0.5,
        diurnal_period_s=duration_s, tenants=args.tenants,
        vocab_size=cfg.vocab_size,
        interactive_max_new=min(args.max_new, 8),
        batch_max_new=min(args.max_new, 8))
    trace = generate_trace(tc)
    rounds = run_open_loop(gw, tokens, trace)
    gw.flush_telemetry()
    m = gw.metrics()
    print(f"engine: gateway saturation demo ({args.replicas} replica(s), "
          f"{args.tenants} tenant(s), open loop "
          f"{offered_load(trace, tc):.1f} req/s offered x {duration_s:.0f}s,"
          f" {rounds} rounds) ({args.device})")
    print(f"arrivals {len(trace)}   completed {m['completed']}   shed "
          f"{m['shed']}   sla rate {m['sla_rate']:.3f}   p95 latency "
          f"{m['p95_latency_s']:.2f}s   SLO burn {m['slo_burn_rate']:.2f}")
    print(f"telemetry: {m['telemetry_flushes']} flushes, "
          f"{m['telemetry_writes']} StateStore writes "
          f"({m['statestore_throttled']} throttled, "
          f"{m['telemetry_dropped']} dropped), "
          f"{len(store.scan('servejob/'))} job records, "
          f"{len(store.scan('audit/'))} audit records, "
          f"{len(store.scan('metrics/'))} metric snapshots")
    print(f"registry: {len(gw.registry.families())} metric families")
    return gw


def _disaggregate_spec(spec: str) -> tuple[int, int]:
    try:
        n_prefill, n_decode = (int(x) for x in spec.split(":"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"want N_PREFILL:N_DECODE, got {spec!r}")
    if n_prefill < 1 or n_decode < 1:
        raise argparse.ArgumentTypeError(
            "need at least one prefill and one decode replica")
    return n_prefill, n_decode


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default="yi-6b")
    ap.add_argument("--engine", choices=("continuous", "static", "auto"),
                    default="auto",
                    help="auto: continuous for a family with a paged "
                         "decode path, static otherwise")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--spec", action="store_true",
                    help="self-speculative decode (n-gram drafts verified "
                         "in one multi-query paged pass; greedy outputs "
                         "are unchanged)")
    ap.add_argument("--kv-dtype", choices=("f32", "int8"), default=None,
                    help="paged KV pool layout (default: config "
                         "kv_cache_dtype); int8 stores pages quantized "
                         "with per-row scales")
    ap.add_argument("--prefill-mode", choices=("paged", "dense"),
                    default="paged",
                    help="continuous engine admission: paged chunked "
                         "prefill, or one ragged dense prefill a pad bucket "
                         "re-laid into pages (no prefix cache, no int8 "
                         "pool)")
    ap.add_argument("--adaptive-k", action="store_true",
                    help="with --spec: per-slot adaptive speculative window")
    ap.add_argument("--gateway", action="store_true",
                    help="serve through the KottaServeGateway: per-tenant "
                         "authorization + audit, tenant-scoped prefix "
                         "cache, deadline/cost-aware admission")
    ap.add_argument("--tenants", type=int, default=2,
                    help="gateway: tenant principals to register")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="gateway: per-request deadline (EDF admission; "
                         "infeasible requests are shed, typed)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="gateway: static on-demand replica count")
    ap.add_argument("--routing", default=None,
                    choices=("affinity", "least-loaded", "blind"),
                    help="gateway: fleet placement policy (default "
                         "affinity: requests land where their prefix is "
                         "already cached, least-loaded fallback, "
                         "load-imbalance capped). Passing the flag also "
                         "gives tenants hot shared prefixes so the demo "
                         "has residency to route on")
    ap.add_argument("--disaggregate", default=None,
                    metavar="N_PREFILL:N_DECODE", type=_disaggregate_spec,
                    help="gateway: split the fleet into prefill-specialized"
                         " and decode-specialized replicas (e.g. 1:2); "
                         "finished KV pages ship prefill -> decode per "
                         "request")
    ap.add_argument("--interactive-burst", action="store_true",
                    help="gateway demo: batch jobs hold every decode slot, "
                         "a tight-deadline interactive burst preempts them "
                         "(lossless pause/resume, pages pinned)")
    ap.add_argument("--no-preempt", action="store_true",
                    help="with --interactive-burst: disable preemption to "
                         "watch the burst shed instead")
    ap.add_argument("--chaos-seed", type=int, default=None, metavar="SEED",
                    help="gateway demo: seeded random fault storm (crashes, "
                         "revocation notices with KV evacuation, "
                         "stragglers, heartbeat loss) over the fleet; every "
                         "job must end DONE or typed-SHED")
    ap.add_argument("--saturation", action="store_true",
                    help="gateway demo: open-loop Poisson/diurnal traffic "
                         "from a Zipf user population with telemetry "
                         "streaming into a write-capped StateStore "
                         "(benchmarks/gateway_bench.py sweeps the full "
                         "offered-load range)")
    ap.add_argument("--metrics-out", type=str, default=None, metavar="PATH",
                    help="gateway modes: write the final Prometheus text "
                         "exposition of the run's MetricsRegistry to PATH")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    if args.adaptive_k and not args.spec:
        raise SystemExit("--adaptive-k requires --spec (it governs the "
                         "speculative draft window)")
    if (args.routing or args.disaggregate) and not args.gateway:
        args.gateway = True      # routing flags only make sense fleet-wide
    cfg = get_reduced_config(args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only (no decode step)")
    fam = get_family(cfg)
    gateway_mode = (args.gateway or args.interactive_burst or args.saturation
                    or args.chaos_seed is not None)
    if gateway_mode:
        if args.prefill_mode != "paged":
            raise SystemExit("--prefill-mode dense is for a direct continuous"
                             " engine; the gateway's engines prefill paged")
        if not hasattr(fam, "decode_paged"):
            raise SystemExit("the gateway modes require a paged-decode "
                             "family")
        if args.replicas < 1 or (args.tenants < 1
                                 and args.chaos_seed is None
                                 and not args.interactive_burst):
            raise SystemExit("the gateway modes need --replicas >= 1 and "
                             "--tenants >= 1")
        params = init_params(cfg, fam.layout(cfg), seed=0,
                             device=args.device)
        if args.chaos_seed is not None:
            gw = _run_chaos(cfg, params, args)
        elif args.saturation:
            gw = _run_saturation(cfg, params, args)
        elif args.interactive_burst:
            gw = _run_interactive_burst(cfg, params, args)
        else:
            gw = _run_gateway(cfg, params, args)
        if args.metrics_out is not None:
            gw.registry.collect()
            Path(args.metrics_out).write_text(gw.registry.expose())
            print(f"wrote {len(gw.registry.families())} metric families "
                  f"(Prometheus text exposition) to {args.metrics_out}")
        return
    if args.metrics_out is not None:
        raise SystemExit("--metrics-out requires a gateway mode (--gateway,"
                         " --saturation, --interactive-burst or "
                         "--chaos-seed): the MetricsRegistry lives in the "
                         "gateway")
    engine_kind = args.engine
    if engine_kind == "auto":
        engine_kind = ("continuous" if hasattr(fam, "decode_paged")
                       else "static")
    if engine_kind == "static":
        if args.spec:
            raise SystemExit("--spec requires the continuous engine")
        if args.prefill_mode != "paged":
            raise SystemExit("--prefill-mode requires the continuous engine")
        if args.kv_dtype == "int8":
            raise SystemExit("--kv-dtype int8 requires the continuous engine "
                             "(the static engine keeps a dense unquantized "
                             "cache)")
    elif not hasattr(fam, "decode_paged"):
        raise SystemExit(f"--engine continuous requires a paged-decode "
                         f"family; {args.arch} is served by --engine static")
    params = init_params(cfg, fam.layout(cfg), seed=0, device=args.device)
    if engine_kind == "continuous":
        engine = ContinuousBatchingEngine(
            cfg, params, max_len=args.max_len, enable_spec_decode=args.spec,
            kv_cache_dtype=args.kv_dtype, prefill_mode=args.prefill_mode,
            spec_adaptive_k=args.adaptive_k or None, device=args.device)
    else:
        engine = ServeEngine(cfg, params, max_len=args.max_len,
                             device=args.device)
    prompts = _demo_prompts(cfg, args.batch)
    out = engine.generate(prompts, max_new=args.max_new)
    print(f"engine: {engine_kind} ({engine.device})")
    for p, toks in zip(prompts, out.tokens.tolist()):
        print(f"{p} -> {toks}")


if __name__ == "__main__":
    main()
