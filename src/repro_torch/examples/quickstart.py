"""Quickstart: the Kotta stack in one file.

Registers a corpus in the secure tiered store, trains a small LM for a few
steps with checkpointing, then serves greedy completions, all through the
public API (the reference's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
        [--steps 20]

The model is the reference's reduced yi-6b with a 512-token vocabulary,
at head_dim 64 where the reference's has 16: the card's bf16 attention
kernels take hd 64, 80, 128, 192 or 256, and their backward 64 or 128.
"""
import argparse

import torch

from ..checkpoint import Checkpointer
from ..configs import get_reduced_config
from ..core import ObjectStore, PolicyEngine, install_standard_roles
from ..data import SyntheticCorpus, TokenLoader
from ..serve import ServeEngine
from ..train import AdamWConfig, ElasticTrainer


def main(device="cuda", steps: int = 20) -> dict:
    # 1. infrastructure: security engine + tiered object store
    engine = PolicyEngine()
    install_standard_roles(engine)
    store = ObjectStore(clock=engine.clock)

    # 2. data: deterministic synthetic corpus under dataset/quickstart/*
    cfg = get_reduced_config("yi-6b").replace(vocab_size=512, head_dim=64)
    keys = SyntheticCorpus.build(store, "quickstart", num_shards=2,
                                 tokens_per_shard=16_384,
                                 vocab_size=cfg.vocab_size)
    loader = TokenLoader(store.get, keys, batch_size=8, seq_len=64)

    # 3. train with tiered checkpointing
    opt = AdamWConfig(learning_rate=3e-3, warmup_steps=5, decay_steps=100)
    trainer = ElasticTrainer(cfg, opt, Checkpointer(store, "quickstart"),
                             seed=0, device=device)
    report = trainer.train(loader, num_steps=steps,
                           checkpoint_every=max(steps // 2, 1))
    print(f"loss: step1={report.losses[1]:.3f} "
          f"step{steps}={report.losses[steps]:.3f}")

    # 4. serve the trained model
    params, _ = trainer.final_state
    engine_srv = ServeEngine(cfg, params, max_len=96, device=device)
    with torch.no_grad():
        result = engine_srv.generate([[1, 2, 3, 4], [9, 8, 7]], max_new=8)
    print("completions:", result.tokens.tolist())
    print(f"checkpoints in store: {trainer.ckpt.steps()} "
          f"(monthly storage cost ${store.monthly_cost():.6f})")
    return {"losses": report.losses, "completions": result.tokens.tolist(),
            "checkpoints": trainer.ckpt.steps()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--steps", type=int, default=20)
    main(**vars(ap.parse_args()))
