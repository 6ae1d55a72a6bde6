"""Kernels of the port and their plain PyTorch versions.

Each kernel wrapper counts its launches in ``LAUNCHES`` (one per kernel
launch, nowhere else), so a run can show that a path went through the
kernel and not through the plain version. ``/inferencia/status`` reports
the counts and ``chip_smoke.py`` reads them.
"""

from __future__ import annotations

import threading


class LaunchCounter:
    """Launch count of one kernel. Engine steps run on executor threads, so
    the increment takes a lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    @property
    def value(self) -> int:
        return self._value

    def add(self) -> None:
        with self._lock:
            self._value += 1

    def reset(self) -> int:
        """Set the count to 0 and return what it was."""
        with self._lock:
            value, self._value = self._value, 0
            return value


LAUNCHES: dict[str, LaunchCounter] = {"flash_attention": LaunchCounter()}


def launch_counts() -> dict[str, int]:
    return {name: counter.value for name, counter in LAUNCHES.items()}


def reset_launch_counts() -> dict[str, int]:
    """Zero every kernel's count; returns the counts as they were."""
    return {name: counter.reset() for name, counter in LAUNCHES.items()}
