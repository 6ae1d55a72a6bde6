"""Login rate limiting (net-new; the reference has none).

A sliding-window ATTEMPT counter keyed by identity (email + client IP):
``LOGIN_RATE_LIMIT`` attempts inside ``LOGIN_RATE_WINDOW_S`` block
further ones with 429 until the oldest ages out; a successful login
clears the key, so a legitimate user who mistypes a couple of times is
never punished after getting in.

Design notes (hardened after self-review):
- **Atomic check+record** (``attempt``): the slot is reserved BEFORE the
  slow scrypt verification, so a parallel burst of N requests gets at
  most ``limit`` password checks — the separate check-then-record shape
  would let the whole burst through while the first scrypt ran.
- **Eviction can't lift an active block**: when the table is full, only
  keys whose entire window already EXPIRED are dropped; if nothing has
  expired, the NEW key goes untracked (fail-open for the flood key)
  rather than evicting someone's fresh/blocked entry — otherwise an
  attacker could erase their own block by flooding unique keys.
- In-memory and per-process by design: the goal is blunting online
  brute-force against scrypt, not cross-replica accounting. OPT-IN via
  settings — the default ``LOGIN_RATE_LIMIT=0`` keeps exact reference
  contract parity (no surprise 429s).
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class AttemptWindow:
    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 max_keys: int = 10_000):
        self._clock = clock
        self._max_keys = max_keys
        self._lock = threading.Lock()
        self._hits: dict[str, list[float]] = {}

    def _prune(self, key: str, window_s: float, now: float) -> list[float]:
        hits = [t for t in self._hits.get(key, []) if now - t < window_s]
        if hits:
            self._hits[key] = hits
        else:
            self._hits.pop(key, None)
        return hits

    def attempt(self, key: str, limit: int, window_s: float) -> float:
        """Atomically check AND record one attempt.

        Returns 0.0 when the attempt may proceed (now counted against the
        window), else the seconds until the key unblocks. ``limit <= 0``
        disables (always 0.0, nothing recorded)."""
        if limit <= 0:
            return 0.0
        now = self._clock()
        with self._lock:
            hits = self._prune(key, window_s, now)
            if len(hits) >= limit:
                return max(0.0, window_s - (now - hits[0]))
            if key not in self._hits and len(self._hits) >= self._max_keys:
                # full table: drop fully-EXPIRED keys first; never evict
                # a BLOCKED entry (a flood of unique keys must not erase
                # an active block). If nothing expired, evict the oldest
                # UNBLOCKED key — failing open for new keys instead would
                # let a sustained flood keep the victim's own key
                # permanently untracked (self-review r3 round 2).
                for k in [
                    k for k, h in self._hits.items()
                    if now - h[-1] >= window_s
                ]:
                    self._hits.pop(k, None)
                if len(self._hits) >= self._max_keys:
                    unblocked = [
                        k for k, h in self._hits.items() if len(h) < limit
                    ]
                    if unblocked:
                        victim = min(
                            unblocked, key=lambda k: self._hits[k][-1]
                        )
                        self._hits.pop(victim, None)
                    else:
                        # every tracked key is a live block (pathological)
                        return 0.0
            self._hits[key] = hits + [now]
            return 0.0

    def clear(self, key: str) -> None:
        with self._lock:
            self._hits.pop(key, None)


# process-wide instance used by the login route
login_failures = AttemptWindow()
