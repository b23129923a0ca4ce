"""Fault-tolerant training driver (`repro/dist/fault_tolerance.py`).

Wraps any ``step_fn(state, batch) -> (state, metrics)`` with the
recovery paths a long run needs:

- **periodic checkpoints** every ``ckpt_every`` completed steps (atomic,
  retained to ``keep``; on a background thread with ``async_ckpt``);
- **NaN/Inf rollback**: a non-finite loss discards the poisoned update,
  restores the last checkpoint (or the host snapshot of the initial
  state) and keeps consuming the batch stream; the bad batch is never
  replayed;
- **checkpoint-on-signal**: SIGTERM/SIGINT set a stop flag; the loop
  saves at the current step and returns.  The handlers are installed
  for one `run` and the previous ones put back when it ends, however it
  ends (a finished driver catches no later signal);
- **restart-resume**: `maybe_restore` reloads the latest checkpoint, and
  ``run(..., start_step=...)`` fast-forwards the (step, batch) stream
  past completed steps.  Batches are keyed by step and the data is a
  function of the step, so a killed-and-resumed run repeats the
  uninterrupted one.

The step may update its state in place (`AdamW.update` does, as the
reference's jitted step donates it): rollback never reads the state a
failed step was given; it restores from the checkpoint store or from the
snapshot taken at construction.

Under data parallelism (``ranks``, a `dist.zero1.Zero1`) the ranks act
alike: a checkpoint gathers the ZeRO-1 moments whole on every rank
(`Zero1.full`), rank 0 alone writes the full state, as the reference
saves global arrays, and a barrier follows; a restore reads the same
files on every rank and each keeps its slice (`Zero1.shard_state`).  The
step's loss is the ranks' mean, so a NaN rollback is decided alike, and
a stop request on any rank stops every rank at the same step
(`Zero1.any`).  Checkpoints are written synchronously there.
"""
from __future__ import annotations

import math
import signal
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

import numpy as np

from repro_torch.dist import checkpoint as ckpt

SIGNALS = (signal.SIGTERM, signal.SIGINT)


@dataclass
class FTConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    nan_rollback: bool = True
    async_ckpt: bool = False
    handle_signals: bool = True      # checkpoint-on-SIGTERM/SIGINT
    # called as step_hook(completed_step, state) after every completed
    # step — tests use it to simulate preemption mid-run.
    step_hook: Optional[Callable[[int, Any], None]] = None
    loss_key: str = "loss"


class _Run:
    """One `FaultTolerantDriver.run`'s scope: on entry it installs the stop
    handlers (main thread only, when asked); on exit, however the run
    ends, it waits for a pending save and puts the previous handlers
    back."""

    def __init__(self, driver: "FaultTolerantDriver"):
        self.driver = driver
        self.previous: dict = {}

    def __enter__(self):
        if (self.driver.cfg.handle_signals
                and threading.current_thread() is threading.main_thread()):
            for s in SIGNALS:
                self.previous[s] = signal.signal(
                    s, lambda signum, frame: self.driver.request_stop())
        return self

    def __exit__(self, *exc):
        self.driver._join_pending()
        for s, h in self.previous.items():
            signal.signal(s, h)
        return False


class FaultTolerantDriver:
    def __init__(self, step_fn: Callable, state: Any, cfg: FTConfig, ranks=None):
        if ranks is not None and cfg.async_ckpt:
            raise ValueError("async checkpoints are written by one thread of one "
                             "process; with ranks, checkpoints are synchronous")
        self.step_fn = step_fn
        self.state = state
        self.cfg = cfg
        self.ranks = ranks
        # Host snapshot for a rollback before the first checkpoint.
        self._init_host = ckpt.to_host(state)
        self._stop = threading.Event()
        self._pending_save: Optional[threading.Thread] = None

    # ------------------------------------------------------------ control
    def request_stop(self) -> None:
        """Ask the loop to checkpoint at the current step and return."""
        self._stop.set()

    def maybe_restore(self) -> int:
        """Load the latest checkpoint into ``state``; return its step (0
        when none exists)."""
        step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is None:
            return 0
        return self._restore(step)

    def _restore(self, step: int) -> int:
        state, step = ckpt.restore(self.cfg.ckpt_dir, self.state, step=step)
        self.state = state if self.ranks is None else self.ranks.shard_state(state)
        return step

    # ------------------------------------------------------------- saving
    def _join_pending(self) -> None:
        if self._pending_save is not None:
            self._pending_save.join()
            self._pending_save = None

    def _save(self, step: int) -> None:
        self._join_pending()
        if self.ranks is not None:
            full = self.ranks.full(self.state)
            if self.ranks.writer:
                ckpt.save(self.cfg.ckpt_dir, full, step, keep=self.cfg.keep)
            del full
            self.ranks.barrier()
        elif self.cfg.async_ckpt:
            self._pending_save = ckpt.save_async(self.cfg.ckpt_dir, self.state, step,
                                                 keep=self.cfg.keep)
        else:
            ckpt.save(self.cfg.ckpt_dir, self.state, step, keep=self.cfg.keep)

    def _rollback(self) -> int:
        """Restore the newest checkpoint (or the initial snapshot); returns
        the step the state was rolled back to."""
        self._join_pending()
        if self.ranks is not None:
            self.ranks.barrier()
        step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is not None:
            return self._restore(step)
        loaded = iter(ckpt.tree_leaves(self._init_host))
        self.state = ckpt.tree_map(lambda ref: ckpt.place(next(loaded).copy(), ref),
                                   self.state)
        return 0

    # ---------------------------------------------------------------- run
    def run(self, batches: Iterable, total_steps: int, start_step: int = 0) -> dict:
        """Consume ``(step_id, batch)`` pairs until ``total_steps`` steps
        have completed; returns losses / rollbacks / final_step / stopped
        / p95_s."""
        cfg = self.cfg
        completed = start_step
        losses: list = []
        times: list = []
        rollbacks = 0
        stopped = False
        with _Run(self):
            for step_id, batch in batches:
                if completed >= total_steps:
                    break
                stop = self._stop.is_set()
                if self.ranks is not None:
                    stop = self.ranks.any(stop)
                if stop:
                    stopped = True
                    self._save(completed)
                    break
                if step_id < completed:
                    continue  # fast-forward a restarted stream
                t0 = time.perf_counter()
                new_state, metrics = self.step_fn(self.state, batch)
                loss = float(metrics[cfg.loss_key])
                times.append(time.perf_counter() - t0)
                if cfg.nan_rollback and not math.isfinite(loss):
                    rollbacks += 1
                    completed = self._rollback()
                    continue  # the poisoned batch is consumed, not retried
                self.state = new_state
                completed += 1
                losses.append(loss)
                if cfg.ckpt_every and completed % cfg.ckpt_every == 0:
                    self._save(completed)
                if cfg.step_hook is not None:
                    cfg.step_hook(completed, self.state)
        return {
            "losses": losses,
            "rollbacks": rollbacks,
            "final_step": completed,
            "stopped": stopped,
            "p95_s": float(np.percentile(times, 95)) if times else 0.0,
        }
