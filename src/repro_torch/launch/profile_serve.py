"""Where the serve path's time goes on the GPU: one profiled ``generate``.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        [--arch yi-6b|zamba2-1.2b|xlstm-350m] [--spec]

Builds the model at full width (bf16, random weights from seed 0) and
serves the 8 prompts of ``chip_smoke.py``'s serve phase for that model, 32
new tokens each, three times in one process: once to warm up (kernel build,
library init), once timed without the profiler, once under
``torch.profiler``. yi-6b (32 layers, bf16 pool) goes through
``ContinuousBatchingEngine`` (``--spec``: speculative decode at K=4);
zamba2-1.2b (38 Mamba2 layers, 6 shared-attention applications) and
xlstm-350m (12 mLSTM/sLSTM pairs) through the static ``ServeEngine``. It
prints both wall times, the summed device time of all kernels, the busy
share (that device time over the unprofiled wall time; one stream, so
kernels do not overlap), the kernel launch count, the kernels that took the
most device time, and every kernel of the port (attention, the SSD scan,
RMSNorm) with its device time and launches. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import get_family, init_params
from repro_torch.serve import ContinuousBatchingEngine, ServeEngine
from repro_torch.serve.prompts import (shared_prefix_prompts,
                                       static_batch_prompts)

MAX_NEW = 32
MAX_LEN = 512
TOP = 12
# Name fragments of the port's kernels, listed wherever they rank.
PORT_KERNELS = ("attn", "flash", "prefill", "ssd", "rmsnorm")


def profile(fn, setup=None) -> dict:
    """``fn`` run three times, each between synchronises: to warm up, timed
    without the profiler, and under ``torch.profiler``; ``setup()``, where
    given, runs before each outside its clock and its result is passed to
    ``fn``. Returns both wall times, the summed device time of all kernels,
    the busy share (that device time over the unprofiled wall; one stream,
    so kernels do not overlap), the kernel launch count and every kernel
    ranked by device time."""
    def once():
        arg = () if setup is None else (setup(),)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*arg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    once()                                          # warm-up
    wall = once()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof = once()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    dev_us = sum(e.self_device_time_total for e in kernels)
    return {"wall_ms": wall * 1e3, "wall_profiled_ms": wall_prof * 1e3,
            "device_ms": dev_us / 1e3, "busy_share": dev_us / 1e6 / wall,
            "launches": sum(e.count for e in kernels),
            "kernels": [{"name": e.key, "count": e.count,
                         "device_ms": e.self_device_time_total / 1e3}
                        for e in kernels]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=("yi-6b", "zamba2-1.2b", "xlstm-350m"),
                    default="yi-6b")
    ap.add_argument("--spec", action="store_true",
                    help="yi-6b: speculative decode at K=4")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.spec and args.arch != "yi-6b":
        raise SystemExit("--spec needs the continuous engine (yi-6b)")
    params = init_params(cfg, get_family(cfg).layout(cfg), seed=0)
    if args.arch == "yi-6b":
        prompts = shared_prefix_prompts(cfg.vocab_size)

        def engine():
            return ContinuousBatchingEngine(
                cfg, params, max_len=MAX_LEN, max_slots=8,
                enable_spec_decode=args.spec, spec_tokens=4)
    else:
        prompts = static_batch_prompts(cfg.vocab_size)

        def engine():
            return ServeEngine(cfg, params, max_len=MAX_LEN)

    engines = []

    def fresh():
        engines.append(engine())
        return engines[-1]

    rec = profile(lambda eng: eng.generate(prompts, max_new=MAX_NEW), fresh)
    eng = engines[-1]
    print(f"{args.arch} {cfg.num_layers} layers, spec={args.spec}, "
          f"{len(prompts)} prompts x {MAX_NEW} new on "
          f"{torch.cuda.get_device_name(0)}: wall {rec['wall_ms']:.1f} ms "
          f"unprofiled, {rec['wall_profiled_ms']:.1f} ms profiled; device "
          f"kernels {rec['device_ms']:.1f} ms, busy share "
          f"{rec['busy_share']:.3f} of the unprofiled wall, "
          f"{rec['launches']} kernel launches"
          + (f", prefill tokens {eng.stats['prefill_tokens']}"
             if hasattr(eng, "stats") else ""))
    for k in rec["kernels"][:TOP]:
        print(f"  {k['device_ms']:9.2f} ms {k['count']:7d}x {k['name'][:100]}")
    print("port kernels:")
    for k in rec["kernels"]:
        if any(w in k["name"] for w in PORT_KERNELS):
            print(f"  {k['device_ms']:9.2f} ms {k['count']:7d}x "
                  f"{k['name'][:100]}")


if __name__ == "__main__":
    main()
