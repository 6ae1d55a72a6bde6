"""Timezone helpers.

Same semantics as the reference (``app/core/timezone.py:17-74``): a cached
ZoneInfo from ``settings.TIMEZONE`` (default America/Sao_Paulo), a local
``now()``, and local<->UTC converters.  All persisted timestamps flow through
``local_to_utc(now())`` so the database stores aware-UTC datetimes.
"""

from __future__ import annotations

from datetime import datetime, timezone as _utc_tz
from functools import lru_cache
from zoneinfo import ZoneInfo

from ics_tpu_torch.core.config import settings


@lru_cache(maxsize=8)
def _zone(name: str) -> ZoneInfo:
    try:
        return ZoneInfo(name)
    except Exception:
        return ZoneInfo("America/Sao_Paulo")


def get_timezone() -> ZoneInfo:
    return _zone(settings.TIMEZONE)


def now() -> datetime:
    """Current time in the configured local timezone (aware)."""
    return datetime.now(get_timezone())


def utcnow() -> datetime:
    return datetime.now(_utc_tz.utc)


def utc_to_local(dt: datetime) -> datetime:
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_utc_tz.utc)
    return dt.astimezone(get_timezone())


def local_to_utc(dt: datetime) -> datetime:
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=get_timezone())
    return dt.astimezone(_utc_tz.utc)
