"""Fault-tolerant training loop.

The port of ``repro/train/loop.py``:

* checkpoint/restart through the CDC store (incremental: adjacent
  checkpoints dedup against each other), atomic manifests;
* deterministic restart: the data loader is a pure function of (seed,
  step), so a resume at step k reproduces exactly the batches of an
  unfailed run (bit-determinism is tested; on a CUDA device it also needs
  ``torch.use_deterministic_algorithms(True)``, which the caller sets);
* straggler monitor: EWMA step time, slow steps logged and surfaced to a
  policy hook;
* restore onto the trainer's device, whatever device saved the checkpoint.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch._tree import tree_map
from repro_torch.checkpoint import CheckpointManager
from repro_torch.service.scheduler import resolve_device

from . import optim, step as step_mod


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 200
    ckpt_every: int = 50
    ckpt_async: bool = False
    log_every: int = 10
    straggler_factor: float = 3.0  # step slower than factor x EWMA -> event
    ewma_alpha: float = 0.1


class StragglerMonitor:
    """EWMA step-time tracker with a pluggable slow-step policy hook."""

    def __init__(self, factor: float, alpha: float, policy: Callable | None = None):
        self.factor = factor
        self.alpha = alpha
        self.policy = policy
        self.ewma: float | None = None
        self.events: List[Dict] = []

    def observe(self, step: int, dt: float):
        if self.ewma is None:
            self.ewma = dt
            return
        if dt > self.factor * self.ewma:
            ev = {"step": step, "dt": dt, "ewma": self.ewma}
            self.events.append(ev)
            if self.policy is not None:
                self.policy(ev)
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt


class Trainer:
    def __init__(
        self,
        cfg,
        opt_cfg: optim.OptConfig,
        loop_cfg: LoopConfig,
        loader,
        ckpt: CheckpointManager | None = None,
        *,
        straggler_policy: Callable | None = None,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.loop_cfg = loop_cfg
        self.loader = loader
        self.ckpt = ckpt
        self.device = resolve_device(device)
        self.monitor = StragglerMonitor(
            loop_cfg.straggler_factor, loop_cfg.ewma_alpha, straggler_policy
        )
        self.train_step = step_mod.make_train_step(cfg, opt_cfg)
        self.history: List[Dict] = []

    # -- state ----------------------------------------------------------------
    def init_state(self, generator: torch.Generator):
        from repro_torch.models import lm

        params = lm.init_params(self.cfg, generator, device=self.device)
        return params, optim.init(self.opt_cfg, params)

    def try_restore(self, params, opt_state):
        """Resume from the newest committed checkpoint if one exists."""
        if self.ckpt is None:
            return 0, params, opt_state
        step, state, extra = self.ckpt.restore(
            tree_like={"params": params, "opt": opt_state}
        )
        if step is None:
            return 0, params, opt_state

        def place(a, b):
            return a.to(device=b.device, dtype=b.dtype)

        p = tree_map(place, state["params"], params)
        o = tree_map(place, state["opt"], opt_state)
        return int(extra.get("next_step", step + 1)), p, o

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The loader's batch for ``step`` on the trainer's device."""
        tokens, labels = self.loader.batch_at(step)
        return {k: torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device, torch.int64)
                for k, a in (("tokens", tokens), ("labels", labels))}

    # -- loop -----------------------------------------------------------------
    def run(self, generator: torch.Generator | None = None,
            steps: int | None = None):
        """Train from ``generator``'s initial weights (seed 0 on the
        trainer's device when none is given), or resume from the newest
        checkpoint, up to ``steps``.  Returns (params, opt_state)."""
        steps = steps or self.loop_cfg.total_steps
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params, opt_state = self.init_state(generator)
        start, params, opt_state = self.try_restore(params, opt_state)

        for step in range(start, steps):
            batch = self.batch_at(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.train_step(params, opt_state, batch)
            rec = {k: float(metrics[k]) for k in ("loss", "grad_norm", "lr")}
            dt = time.perf_counter() - t0  # float() waited for the device
            self.monitor.observe(step, dt)

            rec = {"step": step, **rec, "dt": dt}
            self.history.append(rec)
            if self.loop_cfg.log_every and step % self.loop_cfg.log_every == 0:
                print(
                    f"step {step:5d} loss {rec['loss']:.4f} "
                    f"gnorm {rec['grad_norm']:.3f} lr {rec['lr']:.2e} {dt*1e3:.0f}ms"
                )

            if self.ckpt and (step + 1) % self.loop_cfg.ckpt_every == 0:
                state = {"params": params, "opt": opt_state}
                extra = {"next_step": step + 1}
                if self.loop_cfg.ckpt_async:
                    self.ckpt.save_async(step, state, extra)
                else:
                    self.ckpt.save(step, state, extra)

        if self.ckpt:
            self.ckpt.wait()
        return params, opt_state
