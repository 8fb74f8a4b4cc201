"""End-to-end driver: train an LM under the full Kotta stack.

The paper's execution model applied to training: the job runs on
*preemptible* capacity (spot revocations injected from the market model)
and survives via tiered checkpoints and the deterministic step-indexed
loader (the reference's ``examples/elastic_training.py``). The default is
sized for a CPU (~5M params, 30 steps); ``--full`` selects the
~100M-parameter, 300-step configuration.

    PYTHONPATH=src python -m repro_torch.examples.elastic_training
        [--device cpu] [--full] [--steps N] [--bid USD]
"""
import argparse
import time

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..core import (DEFAULT_ZONES, ObjectStore, PolicyEngine, SpotMarket,
                    install_standard_roles)
from ..data import SyntheticCorpus, TokenLoader
from ..models import count_params
from ..train import AdamWConfig, ElasticTrainer


def build_cfg(full: bool):
    base = get_config("internlm2-1.8b")
    if full:  # ~100M-parameter configuration
        return base.replace(num_layers=10, d_model=640, num_heads=10,
                            num_kv_heads=5, head_dim=64, d_ff=2560,
                            vocab_size=8192, remat="none"), 300, 16, 128
    return base.replace(num_layers=4, d_model=256, num_heads=4,
                        num_kv_heads=2, head_dim=64, d_ff=1024,
                        vocab_size=2048, remat="none"), 30, 4, 64


def main(device="cuda", full: bool = False, steps: int | None = None,
         bid: float = 0.08) -> dict:
    cfg, default_steps, batch, seq = build_cfg(full)
    steps = default_steps if steps is None else steps
    print(f"model: {count_params(cfg) / 1e6:.1f}M params, {steps} steps")

    engine = PolicyEngine()
    install_standard_roles(engine)
    store = ObjectStore(clock=engine.clock)
    keys = SyntheticCorpus.build(store, "corpus", num_shards=4,
                                 tokens_per_shard=max(batch * (seq + 1) * 8,
                                                      65_536),
                                 vocab_size=cfg.vocab_size)
    loader = TokenLoader(store.get, keys, batch_size=batch, seq_len=seq)

    # Preemptible capacity: revoke whenever the us-east-1a spot price spikes
    # above a stingy bid (each revocation costs the steps since the last
    # checkpoint: the paper's §V-B trade-off). The price first passes the
    # bid at step 20 (a bid of 0.05 is passed at step 10).
    market = SpotMarket(seed=4)
    zone, itype = DEFAULT_ZONES[0], "m4.xlarge"
    revoked_steps = []

    def revoke_at(step):
        hour = step / 10.0  # pretend 10 steps/hour for the price trace
        if market.price(zone, itype, hour) > bid and \
                (not revoked_steps or step - revoked_steps[-1] > 15):
            revoked_steps.append(step)
            return True
        return False

    opt = AdamWConfig(learning_rate=3e-3, warmup_steps=10, decay_steps=steps)
    trainer = ElasticTrainer(cfg, opt, Checkpointer(store, "elastic-demo"),
                             seed=0, async_checkpoint=True, device=device)
    t0 = time.time()
    report = trainer.train(loader, steps, checkpoint_every=10,
                           revoke_at=revoke_at)
    dt = time.time() - t0
    print(f"done in {dt:.1f}s: {report.steps_run} steps executed for "
          f"{report.final_step} global steps "
          f"({report.restarts} revocations at {revoked_steps})")
    first, last = min(report.losses), max(report.losses)
    print(f"loss {report.losses[first]:.3f} -> {report.losses[last]:.3f}")
    print(f"checkpoints: {trainer.ckpt.steps()[-3:]} "
          f"(tiered store, ${store.monthly_cost():.6f}/mo)")
    return {"report": report, "revoked_steps": revoked_steps,
            "checkpoints": trainer.ckpt.steps(), "seconds": dt}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None,
                    help="global steps (default 30, or 300 with --full); "
                         "the first revocation comes at step 20")
    ap.add_argument("--bid", type=float, default=0.08,
                    help="spot bid in USD an hour (default 0.08: the price "
                         "first passes it at step 20; 0.05 at step 10)")
    main(**vars(ap.parse_args()))
