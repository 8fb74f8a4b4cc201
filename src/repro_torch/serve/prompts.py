"""The serve workloads that ``chip_smoke.py`` and ``launch/profile_serve.py``
both drive, so that their numbers describe the same requests."""
from __future__ import annotations

import numpy as np


def shared_prefix_prompts(vocab: int, seed: int = 0) -> list[list[int]]:
    """8 prompts of 40-160 tokens; the even ones share a 64-token prefix."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, size=64).tolist()
    prompts = []
    for i, n in enumerate([72, 160, 96, 40, 144, 52, 120, 88]):
        head = shared if i % 2 == 0 else rng.randint(0, vocab, size=64).tolist()
        prompts.append(head + rng.randint(0, vocab, size=n - 64).tolist()
                       if n > 64 else head[:n])
    return prompts


def static_batch_prompts(vocab: int, seed: int = 0) -> list[list[int]]:
    """8 prompts of 160-256 tokens, the longest exactly 256, so the static
    engine left-pads the batch to 256 (two SSD chunks of 128)."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).tolist()
            for n in (256, 160, 224, 176, 240, 192, 208, 168)]
