"""Hybrid sync orchestrator
(reference: ``app/services/nextcloud_sync_service.py``).

``sync_initial``: empty DB => run the WebDAV full scan CONCURRENTLY with an
Activity-API event collector (poll every 5 s, bounded iterations), then
replay the cached events after the scan finishes — closing the race window
between scan snapshot and live changes. Non-empty DB => Activity-API-only
catch-up.

``sync_periodic``: picks WebDAV vs Activity API from SyncStatus freshness/
failure state; marks the server offline after >=3 consecutive failures on
BOTH channels.

The reference used one thread per task; here it's structured asyncio with a
single DB writer per operation (SURVEY.md §7.2 hard-part 4).
"""

from __future__ import annotations

import asyncio
import logging
from datetime import timedelta
from typing import Any, Optional

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.core.config import settings
from ics_tpu_torch.db.engine import Database
from ics_tpu_torch.db.models import ConjuntoImagens
from ics_tpu_torch.sync.activity_sync import ActivityAPISync
from ics_tpu_torch.sync.event_cache import EventCache
from ics_tpu_torch.sync.nextcloud_client import NextCloudClient, get_nextcloud_client
from ics_tpu_torch.sync.sync_cache import FAILURE_THRESHOLD, SyncCache
from ics_tpu_torch.sync.webdav_sync import WebDAVSync

logger = logging.getLogger(__name__)

COLLECTOR_POLL_SECONDS = 5.0
COLLECTOR_MAX_ITERS = 120


class NextCloudSyncService:
    def __init__(self, db: Database, client: Optional[NextCloudClient] = None,
                 on_image_bytes=None):
        self.db = db
        self.client = client or get_nextcloud_client()
        self.cache = SyncCache(db)
        self.event_cache = EventCache()
        # ingestion-front hook: every downloaded image's bytes are offered
        # to the GPU pipeline (classify-on-sync, north star)
        self.on_image_bytes = on_image_bytes

    @classmethod
    def from_settings(cls, db: Database, on_image_bytes=None) -> "NextCloudSyncService":
        return cls(db, on_image_bytes=on_image_bytes)

    # -- initial sync -------------------------------------------------------
    def _db_is_empty(self) -> bool:
        with self.db.session() as s:
            return s.query(ConjuntoImagens).count() == 0

    async def sync_initial(self) -> dict[str, Any]:
        if not self.cache.try_acquire_sync():
            logger.info("sync já em andamento; pulando inicial")
            return {"skipped": True}
        try:
            if self._db_is_empty():
                return await self._sync_initial_empty_db()
            # non-empty DB: incremental catch-up only
            stats = await self._sync_via_activity_api()
            return {**stats, "mode": "activity_catchup"}
        finally:
            self.cache.release_sync()

    async def _sync_initial_empty_db(self) -> dict[str, Any]:
        started = tz.utcnow()
        self.cache.set_initial_webdav_start(started)
        webdav = WebDAVSync(self.client, self.db, on_image_bytes=self.on_image_bytes)
        scan_done = asyncio.Event()

        collector_mark = {"id": 0}

        async def collector() -> None:
            """Buffer live events while the scan runs (race-window closer).

            ``since`` is the last-seen ACTIVITY ID (NextCloud semantics);
            the baseline is the newest ID at scan start. The final
            baseline is exported in ``collector_mark`` — it becomes the
            post-replay watermark (events after it reach the first
            periodic sync; a server-top refresh would skip anything that
            happened DURING the replay window).
            """
            baseline = 0
            try:
                current = await self.client.fetch_activities(since=0, limit=1)
                baseline = max(
                    (int(e.get("activity_id", 0)) for e in current), default=0
                )
            except Exception as exc:
                logger.debug("coletor: baseline indisponível: %s", exc)
            collector_mark["id"] = baseline
            for _ in range(COLLECTOR_MAX_ITERS):
                if scan_done.is_set():
                    return
                try:
                    events = await self.client.fetch_activities(since=baseline)
                    if events:
                        self.event_cache.add_events(events)
                        baseline = max(
                            (int(e.get("activity_id", 0)) for e in events),
                            default=baseline,
                        )
                        collector_mark["id"] = baseline
                except Exception as exc:
                    logger.debug("coletor de eventos: %s", exc)
                try:
                    await asyncio.wait_for(
                        scan_done.wait(), timeout=COLLECTOR_POLL_SECONDS
                    )
                    return
                except asyncio.TimeoutError:
                    pass

        collector_task = asyncio.ensure_future(collector())
        try:
            stats = await webdav.sync_all_folders()
            self.cache.record_webdav_success()
        except Exception as exc:
            self.cache.record_webdav_failure()
            self.cache.set_last_result("error", "initial", str(exc))
            raise
        finally:
            scan_done.set()
            await collector_task

        replay_stats = await self._apply_cached_events()
        now = tz.utcnow()
        self.cache.update_last_webdav_sync(now)
        self.cache.update_last_activity_sync(now)
        # watermark = what the collector actually SAW (its final
        # baseline; replay already advanced past processed events) —
        # never the server's current top, which would skip events that
        # landed during the replay window (self-review r3)
        if collector_mark["id"]:
            status = self.cache.get()
            if collector_mark["id"] > (status.last_activity_id or 0):
                self.cache.update_last_activity_id(collector_mark["id"])
        self.cache.set_last_result("success", "initial", None)
        return {"mode": "initial_full", **stats, "replay": replay_stats}

    async def _apply_cached_events(self) -> dict[str, Any]:
        events = self.event_cache.get_events()
        if not events:
            return {"events_processed": 0}
        activity = ActivityAPISync(self.client, self.db, on_image_bytes=self.on_image_bytes)
        stats = await activity.process_events(events)
        top = max((int(e.get("activity_id", 0)) for e in events), default=0)
        if top:
            self.cache.update_last_activity_id(top)
        self.event_cache.clear()
        return stats

    # -- periodic sync -----------------------------------------------------
    def _should_use_webdav(self) -> bool:
        status = self.cache.get()
        if not status.activity_api_available:
            return True
        if status.last_webdav_sync is None:
            return False  # initial sync covers the first full scan
        age = tz.utcnow() - status.last_webdav_sync
        return age > timedelta(minutes=settings.NEXTCLOUD_SYNC_WEBDAV_INTERVAL)

    async def sync_periodic(self) -> dict[str, Any]:
        if not self.cache.try_acquire_sync():
            return {"skipped": True, "reason": "sync_in_progress"}
        try:
            if self._should_use_webdav():
                return await self._sync_via_webdav()
            return await self._sync_via_activity_api()
        finally:
            self.cache.release_sync()
            self._check_server_offline_status()

    async def _sync_via_activity_api(self) -> dict[str, Any]:
        try:
            available = await self.client.check_activity_api_available()
            if not available:
                self.cache.record_activity_failure()
                return await self._sync_via_webdav()
            status = self.cache.get()
            # NextCloud Activity API: ``since`` is the last-seen activity ID
            # (the reference passed timestamps — broken incremental channel)
            since = status.last_activity_id or 0
            activity = ActivityAPISync(self.client, self.db, on_image_bytes=self.on_image_bytes)
            events = await activity.fetch_events_since(since)
            stats = await activity.process_events(events)
            top = max((int(e.get("activity_id", 0)) for e in events), default=0)
            if top:
                self.cache.update_last_activity_id(top)
            self.cache.record_activity_success()
            self.cache.update_last_activity_sync()
            self.cache.set_last_result("success", "activity_api", None)
            return {"mode": "activity_api", "events": len(events), **stats}
        except Exception as exc:
            failures = self.cache.record_activity_failure()
            self.cache.set_last_result("error", "activity_api", str(exc))
            logger.error("sync via Activity API falhou (%sx): %s", failures, exc)
            return {"mode": "activity_api", "error": str(exc)}

    async def _sync_via_webdav(self) -> dict[str, Any]:
        try:
            webdav = WebDAVSync(self.client, self.db, on_image_bytes=self.on_image_bytes)
            stats = await webdav.sync_all_folders()
            self.cache.record_webdav_success()
            now = tz.utcnow()
            self.cache.update_last_webdav_sync(now)
            self.cache.update_last_activity_sync(now)
            self.cache.set_last_result("success", "webdav", None)
            return {"mode": "webdav", **stats}
        except Exception as exc:
            failures = self.cache.record_webdav_failure()
            self.cache.set_last_result("error", "webdav", str(exc))
            logger.error("sync via WebDAV falhou (%sx): %s", failures, exc)
            return {"mode": "webdav", "error": str(exc)}

    def _check_server_offline_status(self) -> None:
        status = self.cache.get()
        both_failing = (
            (status.activity_api_failures or 0) >= FAILURE_THRESHOLD
            and (status.webdav_failures or 0) >= FAILURE_THRESHOLD
        )
        if both_failing and not status.server_offline:
            logger.error("servidor NextCloud marcado como OFFLINE")
            self.cache.set_server_offline(True)
        elif not both_failing and status.server_offline:
            self.cache.set_server_offline(False)

    # -- health -------------------------------------------------------------
    async def run_health_check(self) -> dict[str, Any]:
        health = await self.client.check_server_health()
        if health["server_online"]:
            if self.cache.is_server_offline():
                logger.info("servidor NextCloud voltou a ficar online")
            self.cache.set_server_offline(False)
            self.cache.set_activity_api_available(health["activity_api_available"])
            if health["webdav_available"]:
                self.cache.record_webdav_success()
        else:
            self.cache.set_server_offline(True)
        return health

    def get_sync_status(self) -> dict[str, Any]:
        row = self.cache.get()
        return {
            "last_activity_api_sync": (
                row.last_activity_api_sync.isoformat()
                if row.last_activity_api_sync else None
            ),
            "last_webdav_sync": (
                row.last_webdav_sync.isoformat() if row.last_webdav_sync else None
            ),
            "activity_api_available": bool(row.activity_api_available),
            "activity_api_failures": row.activity_api_failures,
            "webdav_failures": row.webdav_failures,
            "server_offline": bool(row.server_offline),
            "sync_in_progress": bool(row.sync_in_progress),
            "last_sync_status": row.last_sync_status,
            "last_sync_method": row.last_sync_method,
            "last_sync_error": row.last_sync_error,
        }
