"""In-memory Activity-event buffer
(reference: ``app/services/event_cache.py``).

Collects events observed while the initial WebDAV scan runs, for replay
afterwards — closing the race window between scan snapshot and live changes.
asyncio-native: a plain lock-free list is safe under the single event loop,
but a lock is kept for use from worker threads.
"""

from __future__ import annotations

import threading
from typing import Any


class EventCache:
    def __init__(self) -> None:
        self._events: list[dict[str, Any]] = []
        self._lock = threading.Lock()
        self._seen_ids: set = set()

    def add_events(self, events: list[dict]) -> int:
        added = 0
        with self._lock:
            for event in events:
                key = event.get("activity_id") or id(event)
                if key in self._seen_ids:
                    continue
                self._seen_ids.add(key)
                self._events.append(event)
                added += 1
        return added

    def get_events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._seen_ids.clear()

    def count(self) -> int:
        with self._lock:
            return len(self._events)

    def is_empty(self) -> bool:
        return self.count() == 0
