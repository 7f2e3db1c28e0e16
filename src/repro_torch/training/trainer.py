"""Training loop (``repro/training/trainer.py``): data pipeline →
(micro-batched) train step → metrics, with fault tolerance: auto-resume
from the latest checkpoint, periodic async checkpoints, heartbeat +
straggler watchdog.

Parameters are drawn by ``models.params.init_params`` from a
``torch.Generator`` seeded with ``TrainConfig.seed`` on the trainer's
device, which is the card unless ``device`` names another.  A resumed run
restores the latest checkpoint and skips the data stream to its position
before the first batch is drawn, so it trains on the batches an
uninterrupted run would.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.params import init_params
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.watchdog import Watchdog
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_step import (make_microbatched_train_step,
                                             make_train_step, requires_grad_)


@dataclass
class TrainConfig:
    steps: int = 100
    batch_size: int = 8
    seq_len: int = 128
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    num_micro: int = 1
    seed: int = 0
    log_every: int = 10
    straggler_policy: str = "log"


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 opt: Optional[OptConfig] = None, policy=None,
                 step_fn: Optional[Callable] = None,
                 device: DeviceLike = None):
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        self.opt = opt or OptConfig(warmup_steps=10)
        if step_fn is None:
            if tcfg.num_micro > 1:
                step_fn = make_microbatched_train_step(
                    cfg, self.opt, policy, tcfg.num_micro)
            else:
                step_fn = make_train_step(cfg, self.opt, policy)
        self.step_fn = step_fn
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)
        self.watchdog = Watchdog(policy=tcfg.straggler_policy)
        self.data = DataPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
            batch_size=tcfg.batch_size, seed=tcfg.seed))
        self.metrics_log: list = []

        # init or resume -------------------------------------------------
        self.step = 0
        if self.ckpt and self.ckpt.latest_step() is not None:
            self.step, tree, extra = self.ckpt.restore(device=self.device)
            self.params, self.opt_state = tree["params"], tree["opt_state"]
            self.data.skip(extra.get("data_step", self.step))
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(tcfg.seed)
            self.params = init_params(cfg, gen, self.device)
            self.opt_state = init_opt_state(self.params, self.opt)
        requires_grad_(self.params)

    def _state(self) -> Dict:
        return {"params": self.params, "opt_state": self.opt_state}

    def run(self) -> Dict:
        last = {}
        while self.step < self.tcfg.steps:
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in next(self.data).items()}
            self.watchdog.step_start()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            last = {k: float(v) for k, v in metrics.items()}  # waits
            self.watchdog.step_end()
            self.step += 1
            if self.step % self.tcfg.log_every == 0 or \
                    self.step == self.tcfg.steps:
                self.metrics_log.append({"step": self.step, **last})
            if self.ckpt and self.step % self.tcfg.ckpt_every == 0:
                self.ckpt.save_async(self.step, self._state(),
                                     extra={"data_step": self.data.step})
        if self.ckpt:
            self.ckpt.save(self.step, self._state(),
                           extra={"data_step": self.data.step})
            self.ckpt.wait()
        self.data.close()
        return last
