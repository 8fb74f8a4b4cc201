"""Elastic, fault-tolerant trainer.

Cloud Kotta's execution model applied to training: the trainer is the *job*,
revocations kill it mid-step, the queue-watcher resubmits it, and it resumes
from the latest tiered checkpoint. Because ``TokenLoader.batch_at(step)`` is
pure, a restart replays the exact data order; with deterministic kernels a
restart is bit for bit equal to an uninterrupted run (the card's
``chip_smoke.py`` checks it under ``torch.use_deterministic_algorithms``).

A counterpart of the reference's ``repro/train/trainer.py`` with a
``device=``: parameters are f32 master weights (``cfg.param_dtype``) on the
device, batches become tensors there, and the step runs eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..device import resolve_device
from ..models import get_family, init_params
from . import adamw
from .train_step import build_train_step


class Revoked(Exception):
    """Raised by a revocation signal mid-training (spot reclaim)."""


@dataclass
class TrainerReport:
    steps_run: int
    final_step: int
    losses: dict[int, float] = field(default_factory=dict)
    restarts: int = 0


def _require_grad(params) -> None:
    for p in adamw.tree_leaves(params):
        p.requires_grad_(True)


class ElasticTrainer:
    def __init__(self, cfg, opt_cfg: adamw.AdamWConfig, checkpointer, *,
                 microbatches: int = 1, seed: int = 0,
                 async_checkpoint: bool = False, device="cuda"):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.ckpt = checkpointer
        self.family = get_family(cfg)
        self.microbatches = microbatches
        self.seed = seed
        self.async_checkpoint = async_checkpoint
        self.device = resolve_device(device)
        self._step_fn = build_train_step(cfg, opt_cfg, microbatches)

    # -- state -----------------------------------------------------------------
    def init_state(self):
        """(params, opt_state) from ``seed``; a test may override it to start
        from given weights."""
        params = init_params(self.cfg, self.family.layout(self.cfg),
                             seed=self.seed, device=self.device,
                             dtype=self.cfg.pdtype)
        return params, adamw.init(self.opt_cfg, params)

    def restore_or_init(self):
        params, opt_state = self.init_state()
        step = self.ckpt.latest_step()
        if step is None:
            return 0, params, opt_state
        step, (params, opt_state) = self.ckpt.restore((params, opt_state))
        return step, params, opt_state

    # -- loop ---------------------------------------------------------------------
    def train(self, loader, num_steps: int, *, checkpoint_every: int = 50,
              revoke_at: Optional[Callable[[int], bool]] = None,
              max_restarts: int = 10) -> TrainerReport:
        """Run to ``num_steps`` global steps, surviving revocations."""
        report = TrainerReport(0, 0)
        restarts = 0
        while True:
            start, params, opt_state = self.restore_or_init()
            _require_grad(params)
            try:
                step = start
                while step < num_steps:
                    if revoke_at is not None and revoke_at(step):
                        raise Revoked(f"revoked at step {step}")
                    batch = {k: torch.from_numpy(v).to(self.device)
                             for k, v in loader.batch_at(step).items()}
                    params, opt_state, metrics = self._step_fn(
                        params, opt_state, batch)
                    step += 1
                    report.steps_run += 1
                    report.losses[step] = float(metrics["total_loss"])
                    if step % checkpoint_every == 0 or step == num_steps:
                        self.ckpt.save(step, (params, opt_state),
                                       blocking=not self.async_checkpoint)
                self.ckpt.wait()
                report.final_step = step
                report.restarts = restarts
                self._final = (params, opt_state)
                return report
            except Revoked:
                restarts += 1
                if restarts > max_restarts:
                    raise
                # params/opt_state are lost with the instance; the loop
                # restores them from the latest checkpoint.
                params = opt_state = None
                continue

    @property
    def final_state(self):
        return self._final
