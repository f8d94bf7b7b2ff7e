"""Preemption detection (copy of han_tpu/train/preempt.py).

Cloud VMs receive SIGTERM ahead of preemption (and Borg/GKE evictions send
it too). ``PreemptionGuard`` converts that asynchronous signal into a flag
the training loop polls at safe points (epoch/batch boundaries); the
trainers then write a full resume checkpoint and stop cleanly, so the next
incarnation continues the exact trajectory (tests/test_torch_preempt.py
drives a real SIGTERM through a subprocess).
"""

from __future__ import annotations

import signal
from typing import Iterable


class PreemptionGuard:
    """Latches termination signals; poll ``triggered`` at safe points."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,),
                 install: bool = True):
        self._flag = False
        self._prev = {}
        if install:
            for s in signals:
                self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self._flag = True

    @property
    def triggered(self) -> bool:
        return self._flag

    def trip(self) -> None:
        """Manual trigger (fault injection in tests)."""
        self._flag = True

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}
