"""Sync scheduler (reference: ``app/services/sync_scheduler.py``).

Three asyncio tasks with a shared stop event (the reference used daemon
threads): the Activity-API loop (default every 5 min, freshness-gated), the
WebDAV fallback loop (default every 300 min, only when the Activity API is
marked unavailable), and the health-check loop (5 min offline / 30 min
online cadence, restores availability flags on recovery).
"""

from __future__ import annotations

import asyncio
import logging
from datetime import timedelta
from typing import Any, Optional

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.core.config import settings
from ics_tpu_torch.sync.service import NextCloudSyncService

logger = logging.getLogger(__name__)

HEALTH_INTERVAL_OFFLINE = 5 * 60.0
HEALTH_INTERVAL_ONLINE = 30 * 60.0


class SyncScheduler:
    def __init__(self, service: NextCloudSyncService):
        self.service = service
        self._stop = asyncio.Event()
        self._tasks: list[asyncio.Task] = []
        self.stats = {"activity_runs": 0, "webdav_runs": 0, "health_runs": 0}

    async def start(self, initial: bool = True) -> None:
        self._stop.clear()
        if initial:
            self._tasks.append(
                asyncio.ensure_future(self._run_initial(), )
            )
        self._tasks.append(asyncio.ensure_future(self._activity_loop()))
        self._tasks.append(asyncio.ensure_future(self._webdav_fallback_loop()))
        self._tasks.append(asyncio.ensure_future(self._health_loop()))

    async def stop(self) -> None:
        self._stop.set()
        for task in self._tasks:
            task.cancel()
        for task in self._tasks:
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()

    async def _wait(self, seconds: float) -> bool:
        """Returns True if stopping."""
        try:
            await asyncio.wait_for(self._stop.wait(), timeout=seconds)
            return True
        except asyncio.TimeoutError:
            return False

    async def _run_initial(self) -> None:
        try:
            stats = await self.service.sync_initial()
            logger.info("sync inicial concluído: %s", stats)
        except Exception:
            logger.exception("sync inicial falhou")

    async def _activity_loop(self) -> None:
        interval = settings.NEXTCLOUD_SYNC_ACTIVITY_API_INTERVAL * 60.0
        while not self._stop.is_set():
            if await self._wait(interval):
                return
            try:
                status = self.service.cache.get()
                if status.server_offline:
                    continue
                if not status.activity_api_available:
                    # the Activity API is down: sync_periodic would route
                    # THIS 5-minute tick into a FULL WebDAV scan — that
                    # cadence belongs to _webdav_fallback_loop (300 min);
                    # without this gate a disabled Activity app meant
                    # re-downloading the whole library every 5 minutes
                    # (self-review r3). The health loop restores the flag.
                    continue
                # freshness gate: skip if a sync happened more recently than
                # the interval (e.g. the initial sync just finished)
                last = status.last_activity_api_sync
                if last is not None and (
                    tz.utcnow() - last
                ) < timedelta(seconds=interval * 0.5):
                    continue
                self.stats["activity_runs"] += 1
                await self.service.sync_periodic()
            except Exception:
                logger.exception("activity loop")

    async def _webdav_fallback_loop(self) -> None:
        interval = settings.NEXTCLOUD_SYNC_WEBDAV_INTERVAL * 60.0
        while not self._stop.is_set():
            if await self._wait(interval):
                return
            try:
                status = self.service.cache.get()
                if status.server_offline or status.activity_api_available:
                    continue  # fallback only when Activity API is down
                self.stats["webdav_runs"] += 1
                await self.service.sync_periodic()
            except Exception:
                logger.exception("webdav fallback loop")

    async def _health_loop(self) -> None:
        while not self._stop.is_set():
            offline = self.service.cache.is_server_offline()
            interval = (
                HEALTH_INTERVAL_OFFLINE if offline else HEALTH_INTERVAL_ONLINE
            )
            if await self._wait(interval):
                return
            try:
                self.stats["health_runs"] += 1
                await self.service.run_health_check()
            except Exception:
                logger.exception("health loop")

    def status(self) -> dict[str, Any]:
        return {
            "enabled": True,
            "tasks": len(self._tasks),
            **self.stats,
            **self.service.get_sync_status(),
        }
