"""Fault-tolerant training loop, the JAX package's ``train/loop.py``.

- **Checkpoint/restart**: resumes from the newest checkpoint; the data
  pipeline resumes from the step counter alone (deterministic synthesis),
  so a restart replays no data and skips none.
- **Preemption safety**: SIGTERM/SIGINT flip a flag; the loop finishes the
  step in flight, saves, then returns.
- **Straggler detection**: step times feed an EWMA; a step slower than
  ``straggler_factor x`` the EWMA is logged as a straggler event with its
  slowdown.

A step's time is the host clock around the step, ended by one
``torch.cuda.synchronize`` when the loss lives on the card.  Restoring onto
a device mesh (``shardings=``) comes with the scale-out slice.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticLMDataset


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    checkpoint_every: int = 100
    log_every: int = 10
    straggler_factor: float = 2.0
    ewma_alpha: float = 0.1
    async_checkpoint: bool = True


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags outlier steps (simulated swap hook)."""

    factor: float = 2.0
    alpha: float = 0.1
    ewma: Optional[float] = None
    events: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if self.ewma is not None and dt > self.factor * self.ewma:
            is_straggler = True
            self.events.append({"step": step, "dt": dt,
                                "slowdown": dt / self.ewma})
        self.ewma = dt if self.ewma is None else (
            self.alpha * dt + (1 - self.alpha) * self.ewma)
        return is_straggler


class PreemptionGuard:
    """Flips on SIGTERM/SIGINT; loop drains the current step then saves."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:   # non-main thread (tests)
                    pass

    def _handler(self, signum, frame):
        self.requested = True

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


def train_loop(step_fn: Callable, params, opt_state,
               dataset: SyntheticLMDataset, loop_cfg: LoopConfig,
               ckpt: Optional[CheckpointManager] = None,
               start_step: int = 0,
               metrics_sink: Optional[Callable[[int, Dict], None]] = None,
               preemption: Optional[PreemptionGuard] = None,
               batch_put: Optional[Callable] = None,
               save_extra: Optional[Dict[str, Any]] = None):
    """Run until total_steps or preemption.  Returns final state + report.

    ``save_extra`` is merged into every checkpoint's ``extra`` manifest
    record — how launch code threads run metadata (notably the model's
    ``param_layout`` plan) into the train→serve handoff."""
    monitor = StragglerMonitor(loop_cfg.straggler_factor,
                               loop_cfg.ewma_alpha)
    guard = preemption or PreemptionGuard(install=False)
    history: List[Dict[str, Any]] = []
    step = start_step
    dataset.restore({"step": start_step, "seed": dataset.cfg.seed})

    while step < loop_cfg.total_steps and not guard.requested:
        batch = next(dataset)
        if batch_put is not None:
            batch = batch_put(batch)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if metrics["loss"].is_cuda:
            torch.cuda.synchronize(metrics["loss"].device)
        dt = time.perf_counter() - t0
        straggled = monitor.observe(step, dt)

        if step % loop_cfg.log_every == 0 or straggled:
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step=step, step_time_s=dt, straggler=straggled)
            history.append(rec)
            if metrics_sink:
                metrics_sink(step, rec)

        step += 1
        if ckpt and step % loop_cfg.checkpoint_every == 0:
            ckpt.save(step, {"params": params, "opt_state": opt_state},
                      extra={"data": dataset.state(), **(save_extra or {})},
                      blocking=not loop_cfg.async_checkpoint)

    if ckpt:
        ckpt.wait()                      # drain any in-flight async save
        if guard.requested or step % loop_cfg.checkpoint_every:
            ckpt.save(step, {"params": params, "opt_state": opt_state},
                      extra={"data": dataset.state(),
                             "preempted": guard.requested,
                             **(save_extra or {})},
                      blocking=True)
    report = {
        "final_step": step,
        "preempted": guard.requested,
        "straggler_events": monitor.events,
        "history": history,
    }
    return params, opt_state, report


def resume_or_init(ckpt: Optional[CheckpointManager], init_fn: Callable):
    """Restore the newest checkpoint into ``init_fn()``'s (params,
    opt_state) or return them fresh -> (params, opt_state, start_step)."""
    params, opt_state = init_fn()
    if ckpt is not None:
        latest = ckpt.latest_step()
        if latest is not None:
            tree = ckpt.restore(latest, {"params": params,
                                         "opt_state": opt_state})
            return tree["params"], tree["opt_state"], latest
    return params, opt_state, 0
