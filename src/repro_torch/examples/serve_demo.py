"""Batched serving near the data (paper: 'analytics close to the data').

Continuous-batching greedy decode over a shared *paged* KV cache for a
batch of ragged prompts, with the model weights restored from a
tiered-store checkpoint. Finished sequences free their cache pages for
queued prompts: the serving analogue of the paper's elastic provisioning
(the reference's ``examples/serve_demo.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]
        [--max-new 12]

The model is the reference's reduced mistral-nemo-12b with a 1024-token
vocabulary, at head_dim 64 where the reference's has 16 (the card's bf16
attention kernels take hd 64 and up).
"""
import argparse
import time

import torch

from ..checkpoint import Checkpointer
from ..configs import get_reduced_config
from ..core import ObjectStore, VirtualClock
from ..models import get_family, init_params
from ..serve import ContinuousBatchingEngine


def main(device="cuda", max_new: int = 12) -> dict:
    cfg = get_reduced_config("mistral-nemo-12b").replace(vocab_size=1024,
                                                         head_dim=64)
    fam = get_family(cfg)
    params = init_params(cfg, fam.layout(cfg), seed=0, device=device)

    # round-trip the weights through the tiered store (deploy-from-checkpoint)
    store = ObjectStore(clock=VirtualClock())
    ck = Checkpointer(store, "serve-model")
    ck.save(0, params)
    _, restored = ck.restore(params)
    print(f"restored {_count_leaves(restored)} weight tensors from the "
          f"object store")

    # 2 slots for 4 prompts: the last two queue and are admitted the moment
    # the first finishers evict and free their pages (continuous batching).
    engine = ContinuousBatchingEngine(cfg, restored, max_len=64, max_slots=2,
                                      device=device)
    prompts = [[1, 2, 3], [10, 11], [42, 43, 44, 45], [7]]
    t0 = time.time()
    out = engine.generate(prompts, max_new=max_new)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    for p, toks in zip(prompts, out.tokens.tolist()):
        print(f"prompt {p} -> {toks}")
    n_tok = out.tokens.size
    print(f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s batched on "
          f"{torch.device(device).type})")
    return {"params": params, "restored": restored, "prompts": prompts,
            "tokens": out.tokens.tolist(), "seconds": dt}


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--max-new", type=int, default=12)
    main(**vars(ap.parse_args()))
