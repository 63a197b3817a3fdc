"""Fault-tolerant training loop (port of ``src/repro/train/trainer.py``).

  * durable checkpoints via the link-and-persist manifest protocol
    (checkpoint/manager.py) at a configurable cadence;
  * auto-resume: on construction the Trainer restores the latest committed
    manifest onto its device, or onto its mesh (elastic: the restore
    re-shards to the *current* mesh, which may differ from the mesh, or
    the single device, that wrote the checkpoint);
  * preemption handling: SIGTERM/SIGINT request a final checkpoint + clean
    exit (the cluster scheduler restarts the job, which auto-resumes);
  * failure injection: `fail_at_step` simulates a hard crash (tests drive
    the crash→restart→resume path);
  * straggler monitor: per-step wall time EMA; steps slower than
    `straggler_factor`× the EMA are counted and surfaced in metrics.

The Trainer runs on the CUDA card unless the caller names another device,
and raises when there is none.  With a ``mesh`` it places its params and
AdamW state on it (``train.step.state_shardings``) and runs the mesh's
train step, on the mesh's device type.  Its step donates the params and
optimizer state it owns (updated in place, as JAX's jitted step donates
them), so a step needs no second copy of either.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Iterator, Optional

import torch

from repro_torch._shardmap_compat import place
from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.kernels._lib import resolve_device
from repro_torch.models import backbone, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.step import make_train_step, state_shardings


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_steps: int = 200
    lr_peak: float = 3e-4
    grad_clip: float = 1.0
    microbatch: Optional[int] = None
    fail_at_step: Optional[int] = None  # simulate a hard crash
    straggler_factor: float = 3.0
    log_every: int = 10


class SimulatedFailure(RuntimeError):
    pass


class StragglerMonitor:
    def __init__(self, factor: float):
        self.factor = factor
        self.ema: Optional[float] = None
        self.count = 0

    def record(self, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        self.count += int(slow)
        self.ema = dt if self.ema is None else 0.9 * self.ema + 0.1 * dt
        return slow


class Trainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        tcfg: TrainerConfig,
        data_iter_factory: Callable[[int], Iterator[dict]],
        device=None,
        *,
        mesh=None,
    ):
        if device is None and mesh is not None:
            device = mesh.device_type
        self.device = resolve_device(device, "Trainer")
        self.mesh = mesh
        self.cfg = model_cfg
        self.tcfg = tcfg
        self.data_iter_factory = data_iter_factory
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.monitor = StragglerMonitor(tcfg.straggler_factor)
        self._stop = False
        self.step_fn = make_train_step(
            model_cfg, mesh, lr_peak=tcfg.lr_peak, grad_clip=tcfg.grad_clip,
            microbatch=tcfg.microbatch, donate=True,
        )

        # ---- init or resume ---------------------------------------------
        self.step = 0
        params = init_params(backbone.model_spec(model_cfg), self.device)
        # the params' and AdamW state's placements on the mesh (None without one)
        self.shardings = shardings = state_shardings(model_cfg, mesh) if mesh is not None else None
        if shardings is not None:
            params = place(params, shardings["params"])
        opt = adamw_init(params)
        last = latest_step(tcfg.ckpt_dir)
        if last is not None:
            state = restore(tcfg.ckpt_dir, last, {"params": params, "opt": opt}, shardings,
                            device=self.device)
            params, opt = state["params"], state["opt"]
            self.step = last
            self.resumed_from = last
        else:
            self.resumed_from = None
        self.params, self.opt = params, opt

    # ---- signals --------------------------------------------------------

    def _install_signals(self):
        def handler(signum, frame):  # noqa: ARG001
            self._stop = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not in main thread (tests)

    # ---- main loop ------------------------------------------------------

    def run(self) -> dict:
        self._install_signals()
        it = self.data_iter_factory(self.step)
        history = []
        loss = None
        while self.step < self.tcfg.max_steps and not self._stop:
            batch = {k: torch.from_numpy(x).to(self.device) for k, x in next(it).items()}
            t0 = time.perf_counter()
            out = self.step_fn(self.params, self.opt, batch, self.step)
            loss = float(out.metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            slow = self.monitor.record(dt)
            self.params, self.opt = out.params, out.opt_state
            self.step += 1

            if self.tcfg.fail_at_step is not None and self.step == self.tcfg.fail_at_step:
                raise SimulatedFailure(f"injected failure at step {self.step}")

            if self.step % self.tcfg.log_every == 0 or slow:
                history.append(
                    {
                        "step": self.step,
                        "loss": loss,
                        "grad_norm": float(out.metrics["grad_norm"]),
                        "sec_per_step": dt,
                        "straggler_events": self.monitor.count,
                    }
                )
            if self.step % self.tcfg.ckpt_every == 0:
                self._save()
        self._save()
        return {
            "final_step": self.step,
            "final_loss": loss,
            "history": history,
            "straggler_events": self.monitor.count,
            "resumed_from": self.resumed_from,
        }

    def _save(self):
        self.ckpt.save(
            self.step,
            {"params": self.params, "opt": self.opt},
            extra={"step": self.step},
        )
