"""Trainer: data pipeline + train step + fault-tolerance plumbing (the
reference's ``repro.training.trainer``).

Wires together, as the reference's does:
  * the deterministic sharded loader (resume-aware: restarts mid-epoch
    exactly),
  * ``CheckpointManager`` (periodic, atomic; the reference's layout and
    state tree, so either package resumes the other's runs; the manifest's
    ``extra`` also records the model config, which ``launch/quantize.py
    --from-checkpoint`` reads),
  * ``PreemptionGuard`` (SIGTERM → final checkpoint, ≤ 1 step lost),
  * ``HeartbeatMonitor`` (straggler/dead-host detection feed),
  * optional int8 gradient compression with error feedback.

The state lives on the trainer's ``device`` (the card unless the caller
asks for the CPU); a batch is copied there each step. A fresh run's
parameters come from the port's ``init_params`` seeded by ``seed`` (not
the reference's random bits: a caller that wants the reference's
initial weights passes ``init_state(params=from_jax_params(...))``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.artifacts.format import model_config_to_json
from repro_torch.convert import reference_ndims
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.compress import compress_decompress, init_error_feedback
from repro_torch.runtime import clock as rtclock
from repro_torch.runtime.checkpoint import CheckpointManager, restore_to_device
from repro_torch.runtime.monitor import HeartbeatMonitor
from repro_torch.runtime.preempt import PreemptionGuard
from repro_torch.training.train_step import (grads_of, init_train_state,
                                             make_train_step, state_from_tree,
                                             state_tree)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_interval: int = 50
    ckpt_keep: int = 2
    log_interval: int = 10
    grad_compress: bool = False
    seed: int = 0
    run_dir: Optional[str] = None    # heartbeats


class Trainer:
    def __init__(self, model_cfg, opt: AdamW, data_cfg: DataConfig,
                 tcfg: TrainerConfig,
                 log_fn: Callable[[str], None] = print, device="cuda"):
        self.cfg = model_cfg
        self.opt = opt
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.loader = ShardedLoader(data_cfg)
        self.log = log_fn
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, tcfg.ckpt_interval,
                                       tcfg.ckpt_keep)
                     if tcfg.ckpt_dir else None)
        self.hb = (HeartbeatMonitor(tcfg.run_dir) if tcfg.run_dir else None)
        self._step_fn = self._build_step()
        self.history: list[Dict[str, float]] = []
        # stub modality frontend for [audio]/[vlm] archs: tokens -> fixed
        # pseudo-embeddings (the frontend is frozen and out of scope)
        self._stub_embed = None
        if not model_cfg.embed_inputs:
            rng = np.random.default_rng(tcfg.seed)
            self._stub_embed = rng.standard_normal(
                (512, model_cfg.d_model)).astype(np.float32) * 0.02

    # ------------------------------------------------------------------ build
    def _build_step(self):
        base = make_train_step(self.cfg, self.opt)
        if not self.tcfg.grad_compress:
            return base

        cfg, opt = self.cfg, self.opt

        def step_with_compression(state, batch):
            model = state["params"]
            loss, grads = grads_of(model, cfg, batch)
            grads, state["err"] = compress_decompress(grads, state["err"])
            opt.update(grads, state["opt"], list(model.parameters()),
                       reference_ndims(model, cfg))
            state["step"].add_(1)
            return state, {"loss": loss}

        return step_with_compression

    def init_state(self, params=None) -> Dict[str, Any]:
        """A fresh state on the trainer's device: the port's initialisation
        from ``seed``, or the model ``params``."""
        if params is None:
            dev = self.device
            params = init_params(self.cfg, torch.Generator(device=dev)
                                 .manual_seed(self.tcfg.seed), device=dev)
        else:
            params = params.to(self.device)
        state = init_train_state(self.cfg, params, self.opt)
        if self.tcfg.grad_compress:
            state["err"] = init_error_feedback(list(params.parameters()))
        return state

    def _batch(self, host: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if self._stub_embed is not None:
            host = {"embeddings": self._stub_embed[host["tokens"] % 512],
                    "labels": host["labels"]}
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in host.items()}

    # ------------------------------------------------------------------- run
    def fit(self, state: Optional[Dict[str, Any]] = None,
            guard: Optional[PreemptionGuard] = None) -> Dict[str, Any]:
        start_step = 0
        if state is None:
            if self.ckpt is not None:
                try:
                    start_step, host_tree, _ = self.ckpt.restore_latest()
                    state = state_from_tree(
                        restore_to_device(host_tree, self.device), self.cfg,
                        self.device)
                    self.log(f"[trainer] resumed from step {start_step}")
                except FileNotFoundError:
                    state = self.init_state()
            else:
                state = self.init_state()

        stream = self.loader.iterate(start_step)
        with (guard or PreemptionGuard()) as guard:
            for step in range(start_step, self.tcfg.total_steps):
                batch = self._batch(next(stream))
                t0 = rtclock.now()
                state, metrics = self._step_fn(state, batch)
                loss = float(metrics["loss"])
                dt = rtclock.now() - t0
                self.history.append({"step": step + 1, "loss": loss,
                                     "time_s": dt})
                if self.hb:
                    self.hb.beat(step + 1, dt, loss=loss)
                if (step + 1) % self.tcfg.log_interval == 0:
                    self.log(f"[trainer] step {step + 1} "
                             f"loss {loss:.4f} ({dt * 1e3:.0f} ms)")
                if self.ckpt and (self.ckpt.should_save(step + 1)
                                  or guard.preempted):
                    self._save(step + 1, state)
                    self.log(f"[trainer] checkpoint @ {step + 1}")
                if guard.preempted:
                    self.log("[trainer] preempted: exiting cleanly")
                    break
        self.loader.close()
        if self.ckpt and not guard.preempted:
            self._save(int(state["step"]), state)
        return state

    def _save(self, step: int, state: Dict[str, Any]) -> None:
        self.ckpt.save(step, state_tree(state, self.cfg),
                       extra={"model_config": model_config_to_json(self.cfg)})
