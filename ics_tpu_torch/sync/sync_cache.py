"""Sync state cache over the ``sync_status`` singleton row
(reference: ``app/services/sync_cache.py``).

Failure counters auto-mark a channel unavailable at >=3 consecutive
failures; ``sync_in_progress`` is the cross-task mutex persisted in the DB
(crash-safe, visible to every process).
"""

from __future__ import annotations

from datetime import datetime
from typing import Optional

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.db.engine import Database
from ics_tpu_torch.db.models import SyncStatus

FAILURE_THRESHOLD = 3


class SyncCache:
    def __init__(self, db: Database):
        self.db = db
        self._ensure_row()

    def _ensure_row(self) -> None:
        with self.db.session() as s:
            row = s.get(SyncStatus, 1)
            if row is None:
                now = tz.utcnow()
                s.add(SyncStatus(id=1, created_at=now, updated_at=now))
            elif row.sync_in_progress:
                # stale-lock recovery: SyncCache is constructed once per
                # process start, so a set flag here means a previous process
                # crashed mid-sync; clearing it keeps the mutex crash-safe
                row.sync_in_progress = False
                row.updated_at = tz.utcnow()
            s.commit()

    def _update(self, **fields) -> None:
        with self.db.session() as s:
            row = s.get(SyncStatus, 1)
            for key, value in fields.items():
                setattr(row, key, value)
            row.updated_at = tz.utcnow()
            s.commit()

    def get(self) -> SyncStatus:
        with self.db.session() as s:
            return s.get(SyncStatus, 1)

    # -- watermarks -----------------------------------------------------
    def update_last_activity_sync(self, when: Optional[datetime] = None) -> None:
        self._update(last_activity_api_sync=when or tz.utcnow())

    def update_last_activity_id(self, activity_id: int) -> None:
        row = self.get()
        if activity_id > (row.last_activity_id or 0):
            self._update(last_activity_id=activity_id)

    def update_last_webdav_sync(self, when: Optional[datetime] = None) -> None:
        self._update(last_webdav_sync=when or tz.utcnow())

    def set_initial_webdav_start(self, when: Optional[datetime] = None) -> None:
        self._update(webdav_initial_sync_start=when or tz.utcnow())

    # -- failure counters / availability -----------------------------------
    def record_activity_failure(self) -> int:
        row = self.get()
        failures = (row.activity_api_failures or 0) + 1
        fields = {"activity_api_failures": failures}
        if failures >= FAILURE_THRESHOLD:
            fields["activity_api_available"] = False
        self._update(**fields)
        return failures

    def record_activity_success(self) -> None:
        self._update(
            activity_api_failures=0,
            activity_api_available=True,
            activity_api_last_check=tz.utcnow(),
        )

    def record_webdav_failure(self) -> int:
        row = self.get()
        failures = (row.webdav_failures or 0) + 1
        self._update(webdav_failures=failures)
        return failures

    def record_webdav_success(self) -> None:
        self._update(webdav_failures=0)

    def is_activity_api_available(self) -> bool:
        return bool(self.get().activity_api_available)

    def set_activity_api_available(self, available: bool) -> None:
        fields = {
            "activity_api_available": available,
            "activity_api_last_check": tz.utcnow(),
        }
        if available:
            fields["activity_api_failures"] = 0
        self._update(**fields)

    # -- server offline ------------------------------------------------------
    def set_server_offline(self, offline: bool) -> None:
        self._update(server_offline=offline, last_health_check=tz.utcnow())

    def is_server_offline(self) -> bool:
        return bool(self.get().server_offline)

    # -- mutex ---------------------------------------------------------------
    def try_acquire_sync(self) -> bool:
        with self.db.session() as s:
            row = s.get(SyncStatus, 1)
            if row.sync_in_progress:
                return False
            row.sync_in_progress = True
            row.updated_at = tz.utcnow()
            s.commit()
            return True

    def release_sync(self) -> None:
        self._update(sync_in_progress=False)

    def is_sync_in_progress(self) -> bool:
        return bool(self.get().sync_in_progress)

    # -- result bookkeeping ----------------------------------------------------
    def set_last_result(
        self, status: str, method: str, error: Optional[str] = None
    ) -> None:
        self._update(
            last_sync_status=status, last_sync_method=method, last_sync_error=error
        )
