"""Where the serve path's time goes on the GPU: one profiled ``generate``.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--spec]

Builds yi-6b at full width (32 layers, bf16 pool, random weights from seed
0) and serves the 8 prompts of ``chip_smoke.py``'s serve phase, 32 new
tokens each, three times in one process: once to warm up (kernel build,
library init), once timed without the profiler, once under
``torch.profiler``. It prints both wall times, the summed device time of
all kernels, the busy share (that device time over the unprofiled wall
time; one stream, so kernels do not overlap), the kernel launch count, and
the kernels that took the most device time. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import get_family, init_params
from repro_torch.serve import ContinuousBatchingEngine
from repro_torch.serve.prompts import shared_prefix_prompts

MAX_NEW = 32
TOP = 12


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spec", action="store_true",
                    help="speculative decode at K=4")
    args = ap.parse_args(argv)
    cfg = get_config("yi-6b")
    params = init_params(cfg, get_family(cfg).layout(cfg), seed=0)
    prompts = shared_prefix_prompts(cfg.vocab_size)

    def run():
        eng = ContinuousBatchingEngine(
            cfg, params, max_len=512, max_slots=8,
            enable_spec_decode=args.spec, spec_tokens=4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, max_new=MAX_NEW)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, eng

    run()                                           # warm-up
    wall, _ = run()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof, eng = run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"yi-6b 32 layers, spec={args.spec}, {len(prompts)} prompts x "
          f"{MAX_NEW} new on {torch.cuda.get_device_name(0)}: wall "
          f"{wall * 1e3:.1f} ms unprofiled, {wall_prof * 1e3:.1f} ms "
          f"profiled; device kernels {dev_us / 1e3:.1f} ms, busy share "
          f"{dev_us / 1e6 / wall:.3f} of the unprofiled wall, {launches} "
          f"kernel launches, prefill tokens {eng.stats['prefill_tokens']}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x "
              f"{e.key[:100]}")


if __name__ == "__main__":
    main()
