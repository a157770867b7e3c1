"""Training guards: preemption-safe checkpointing and a NaN fail-fast
(port of vtoonify_tpu/train/guards.py: `PreemptionGuard`,
`handle_preemption`, `check_finite_metrics`, `enable_nan_debugging`).

* PreemptionGuard: job schedulers deliver SIGTERM with a grace window
  before the kill. The guard flips a flag from the signal handler; the
  training loop polls it once per iteration and, when set, saves the full
  train state (the file `--resume` reads) and exits cleanly.
* check_finite_metrics: a non-finite loss means every later iteration is
  wasted (the optimizer state is already poisoned), so it raises at once.
  With --debug_nans the trainers turn on autograd's anomaly detection,
  which names the backward op that produced the first NaN.
"""

from __future__ import annotations

import math
import signal
from typing import Iterable


class PreemptionGuard:
    """Installs handlers for `signals`; `requested` turns True on delivery.

    Handlers chain: a previously installed handler still runs. Handlers can
    only be installed in the main thread; elsewhere the guard is never
    requested."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self.requested = False
        self.signum = None
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handle)
            except ValueError:       # not in the main thread
                pass

    def _handle(self, signum, frame):
        self.requested = True
        self.signum = signum
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def uninstall(self):
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev if prev is not None else signal.SIG_DFL)
            except ValueError:
                pass
        self._prev = {}


def handle_preemption(guard: PreemptionGuard, save_fn, step: int) -> bool:
    """If preemption was requested, run `save_fn()` and report True (the
    caller returns from its training loop)."""
    if not guard.requested:
        return False
    save_fn()
    print(f"preemption (signal {guard.signum}) at step {step}: full train "
          "state saved — rerun with --resume to continue exactly", flush=True)
    return True


def check_finite_metrics(metrics: dict, step: int) -> None:
    """Raise if any loss is NaN or Inf: the poisoned-optimizer fail-fast."""
    bad = {k: float(v) for k, v in metrics.items()
           if not math.isfinite(float(v))}
    if bad:
        raise FloatingPointError(
            f"non-finite training metrics at step {step}: {bad} — the "
            "optimizer state is already poisoned; stopping. Re-run with "
            "--debug_nans to have autograd name the op that produced the "
            "first NaN, and resume from the last checkpoint with --resume.")


def enable_nan_debugging() -> None:
    """`--debug_nans`: autograd's anomaly detection raises at the first
    backward op that returns NaN and prints the forward op's traceback
    (slower; debug only)."""
    import torch

    torch.autograd.set_detect_anomaly(True)
