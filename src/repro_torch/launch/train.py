"""Training launcher: train an architecture end to end under the Kotta stack.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --steps 20 [--device cpu]

The reference's CLI (``repro/launch/train.py``) with ``--device``: a
reduced config, trained on a synthetic corpus registered in the port's
:class:`ObjectStore` under a :class:`PolicyEngine` with the standard roles,
through :class:`ElasticTrainer` with checkpoints in the same store. The
default device is ``cuda``, which fails without a GPU: pass ``--device
cpu`` to run the plain PyTorch path. Full-width training runs from
``chip_smoke.py``, through the library. Prints the parameter count, then
``steps=N loss a -> b; checkpoints [...]``.
"""
import argparse

from ..checkpoint import Checkpointer
from ..configs import ARCH_NAMES, get_reduced_config
from ..core import ObjectStore, PolicyEngine, install_standard_roles
from ..data import SyntheticCorpus, TokenLoader
from ..models import count_params
from ..train import AdamWConfig, ElasticTrainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default="yi-6b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--run-name", default="train-cli")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    cfg = get_reduced_config(args.arch)
    if cfg.family in ("audio", "vlm"):
        raise SystemExit(f"{args.arch}: modality-frontend archs train via "
                         "their smoke tests; use a text arch here")
    print(f"{cfg.name} (reduced): {count_params(cfg) / 1e6:.2f}M params "
          f"({args.device})")

    engine = PolicyEngine()
    install_standard_roles(engine)
    store = ObjectStore(clock=engine.clock)
    keys = SyntheticCorpus.build(
        store, "cli", num_shards=2,
        tokens_per_shard=max(65_536, args.batch * (args.seq + 1) * 8),
        vocab_size=cfg.vocab_size)
    loader = TokenLoader(store.get, keys, batch_size=args.batch,
                         seq_len=args.seq)
    opt = AdamWConfig(learning_rate=args.lr, warmup_steps=5,
                      decay_steps=max(args.steps, 10))
    trainer = ElasticTrainer(cfg, opt, Checkpointer(store, args.run_name),
                             microbatches=args.microbatches, seed=0,
                             device=args.device)
    rep = trainer.train(loader, args.steps,
                        checkpoint_every=args.checkpoint_every)
    first, last = min(rep.losses), max(rep.losses)
    print(f"steps={rep.final_step} loss {rep.losses[first]:.4f} -> "
          f"{rep.losses[last]:.4f}; checkpoints {trainer.ckpt.steps()}")


if __name__ == "__main__":
    main()
