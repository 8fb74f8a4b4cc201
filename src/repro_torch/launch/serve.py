"""Serving launcher: greedy decode of a reduced model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --batch 4 --max-new 16 [--spec [--adaptive-k]] [--kv-dtype int8] \\
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --engine static --batch 4 --max-new 8 [--device cpu]

``--engine auto`` (the default) picks the continuous-batching engine for a
family with a paged decode path (yi-6b) and the static ``ServeEngine``
otherwise (Zamba2). Weights are random, drawn on the device from seed 0;
prompts from seed 1. Prints ``engine: <kind> (<device>)`` and then
``prompt -> tokens`` lines. The default device is ``cuda``, which fails
without a GPU: pass ``--device cpu`` to run the plain PyTorch path.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCH_NAMES, get_reduced_config
from repro_torch.models import get_family, init_params
from repro_torch.serve import ContinuousBatchingEngine, ServeEngine


def _demo_prompts(cfg, batch: int) -> list[list[int]]:
    rng = np.random.RandomState(1)
    return [rng.randint(0, cfg.vocab_size, size=3 + i % 4).tolist()
            for i in range(batch)]


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
    ap.add_argument("--adaptive-k", action="store_true",
                    help="with --spec: per-slot adaptive speculative window")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    if args.adaptive_k and not args.spec:
        raise SystemExit("--adaptive-k requires --spec (it governs the "
                         "speculative draft window)")
    cfg = get_reduced_config(args.arch)
    fam = get_family(cfg)
    engine_kind = args.engine
    if engine_kind == "auto":
        engine_kind = ("continuous" if hasattr(fam, "decode_paged")
                       else "static")
    if engine_kind == "static":
        if args.spec:
            raise SystemExit("--spec requires the continuous engine")
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
            kv_cache_dtype=args.kv_dtype,
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
