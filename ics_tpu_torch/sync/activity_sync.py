"""Activity-API incremental sync — event-driven delta
(reference: ``app/services/activity_api_sync.py``).

Processes NextCloud activity events since a watermark: folders before
files; handlers resolve the event path via WebDAV, then
download/hash/upsert (created), tombstone by path (deleted), refresh etag
metadata (changed), treat moved/changed-folder as changed. Per-run
processed/failed path caches avoid rework inside one sync pass.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Optional

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.core.config import settings
from ics_tpu_torch.core.security import sha256_hex
from ics_tpu_torch.db.engine import Database, IntegrityError
from ics_tpu_torch.db.models import ConjuntoImagens, Imagem
from ics_tpu_torch.sync.nextcloud_client import IMAGE_EXTENSIONS, NextCloudClient
from ics_tpu_torch.sync.webdav_sync import (
    WebDAVSync,
    extract_metadata,
    validate_image_entry,
)

logger = logging.getLogger(__name__)

RELEVANT_TYPES = {
    "file_created", "file_deleted", "file_changed", "file_moved",
    "folder_created", "folder_deleted", "folder_changed",
}


def _event_path(event: dict) -> str:
    return (event.get("object_name") or "").lstrip("/")


def _is_image_path(path: str) -> bool:
    return path.lower().endswith(IMAGE_EXTENSIONS)


class ActivityAPISync:
    def __init__(self, client: NextCloudClient, db: Database,
                 on_image_bytes=None):
        self.client = client
        self.db = db
        self.on_image_bytes = on_image_bytes  # device ingestion hook
        self._processed_paths: set[str] = set()
        self._failed_paths: set[str] = set()

    # pagination bound: 50 pages x 200 events covers a 10k-event burst
    # between polls; anything larger falls to the WebDAV full scan
    MAX_ACTIVITY_PAGES = 50

    async def fetch_events_since(self, since_id: int) -> list[dict]:
        """Drain the activity feed from ``since_id`` (activity-ID
        watermark, ascending pages): a single capped fetch would drop
        every event beyond the first page AND then jump the watermark
        past them (self-review r3)."""
        out: list[dict] = []
        cursor = since_id
        for _ in range(self.MAX_ACTIVITY_PAGES):
            page = await self.client.fetch_activities(since=cursor)
            if not page:
                break
            out.extend(page)
            top = max(
                (int(e.get("activity_id", 0)) for e in page), default=cursor
            )
            if top <= cursor or len(page) < 200:
                break  # drained (or a non-advancing server: stop looping)
            cursor = top
        return out

    # -- orchestration -----------------------------------------------------
    async def process_events(self, events: list[dict]) -> dict[str, Any]:
        stats = {
            "events_processed": 0, "events_skipped": 0, "errors": [],
            "folders_created": 0, "folders_updated": 0,
            "images_created": 0, "images_updated": 0, "images_removed": 0,
        }
        relevant = [e for e in events if e.get("type") in RELEVANT_TYPES]
        stats["events_skipped"] = len(events) - len(relevant)
        # CHRONOLOGICAL order is load-bearing: the API (and the test
        # fake) returns newest-first — applying a folder's re-create
        # before its earlier delete would tombstone live data
        # (self-review r3)
        relevant.sort(key=lambda e: int(e.get("activity_id") or 0))
        folder_events = [e for e in relevant if e.get("type", "").startswith("folder_")]
        file_events = [e for e in relevant if e.get("type", "").startswith("file_")]

        # folders first: files inside a new folder need their conjunto row
        for event in folder_events:
            try:
                etype = event.get("type")
                if etype == "folder_created":
                    if await self.process_folder_created(event):
                        stats["folders_created"] += 1
                elif etype == "folder_deleted":
                    if self.process_folder_deleted(event):
                        stats["folders_updated"] += 1
                elif etype == "folder_changed":
                    if await self.process_folder_changed(event):
                        stats["folders_updated"] += 1
                stats["events_processed"] += 1
            except Exception as exc:
                msg = f"Erro ao processar evento {event.get('type')}: {exc}"
                logger.error(msg)
                stats["errors"].append(msg)

        for event in file_events:
            try:
                etype = event.get("type")
                if etype == "file_created":
                    result = await self.process_file_created(event)
                    if result == "created":
                        stats["images_created"] += 1
                    elif result == "updated":
                        stats["images_updated"] += 1
                elif etype == "file_deleted":
                    if self.process_file_deleted(event):
                        stats["images_removed"] += 1
                elif etype in ("file_changed", "file_moved"):
                    if await self.process_file_changed(event):
                        stats["images_updated"] += 1
                stats["events_processed"] += 1
            except Exception as exc:
                msg = f"Erro ao processar evento {event.get('type')}: {exc}"
                logger.error(msg)
                stats["errors"].append(msg)
        return stats

    # -- folder handlers -------------------------------------------------------
    async def _find_folder_info(self, folder_path: str) -> Optional[dict]:
        parent = folder_path.rsplit("/", 1)[0] if "/" in folder_path else ""
        name = folder_path.rsplit("/", 1)[-1]
        items = await self.client.list_folder(parent, depth=1)
        for item in items:
            if item.get("is_collection") and (
                item.get("path", "").strip("/") == folder_path.strip("/")
                or item.get("name") == name
            ):
                return item
        return None

    async def process_folder_created(self, event: dict) -> bool:
        folder_path = _event_path(event)
        if not folder_path:
            return False
        info = await self._find_folder_info(folder_path)
        if info is None or not info.get("file_id"):
            return False
        webdav = WebDAVSync(self.client, self.db)
        await webdav.sync_folder(info)
        return True

    def process_folder_deleted(self, event: dict) -> bool:
        folder_path = _event_path(event)
        if not folder_path:
            return False
        now = tz.utcnow()
        with self.db.session() as s:
            conjunto = (
                s.query(ConjuntoImagens)
                .filter(ConjuntoImagens.caminho_conj == folder_path)
                .first()
            )
            if conjunto is None and "/" not in folder_path:
                # basename fallback ONLY for root-level paths: a nested
                # 'archive/vacation' deletion must never tombstone an
                # unrelated root conjunto named 'vacation' (and all its
                # images) just because the basenames match
                # (self-review r3)
                conjunto = (
                    s.query(ConjuntoImagens)
                    .filter(ConjuntoImagens.nome_conj == folder_path)
                    .first()
                )
            if conjunto is None:
                return False
            conjunto.existe_no_nextcloud = False
            conjunto.data_sinc = now
            s.execute(
                "UPDATE imagens SET existe_no_nextcloud = 0, data_sinc = ? "
                "WHERE id_cnj = ?",
                [now.isoformat(), conjunto.id_cnj],
            )
            s.commit()
        return True

    async def process_folder_changed(self, event: dict) -> bool:
        return await self.process_folder_created(event)

    # -- file handlers -----------------------------------------------------------
    async def _resolve_conjunto(self, folder_path: str) -> Optional[str]:
        with self.db.session() as s:
            conjunto = (
                s.query(ConjuntoImagens)
                .filter(ConjuntoImagens.caminho_conj == folder_path)
                .first()
            )
            if conjunto is not None:
                return conjunto.id_cnj
        # unknown folder: sync it first
        info = await self._find_folder_info(folder_path)
        if info is None:
            return None
        webdav = WebDAVSync(self.client, self.db)
        await webdav.sync_folder(info)
        with self.db.session() as s:
            conjunto = (
                s.query(ConjuntoImagens)
                .filter(ConjuntoImagens.file_id == info.get("file_id", ""))
                .first()
            )
            return conjunto.id_cnj if conjunto else None

    async def _lookup_file_info(self, file_path: str) -> Optional[dict]:
        parent = file_path.rsplit("/", 1)[0] if "/" in file_path else ""
        name = file_path.rsplit("/", 1)[-1]
        items = await self.client.list_folder(parent, depth=1)
        for item in items:
            if item.get("is_collection"):
                continue
            if (
                item.get("path", "").strip("/") == file_path.strip("/")
                or item.get("name") == name
            ):
                return item
        return None

    async def process_file_created(self, event: dict) -> Optional[str]:
        file_path = _event_path(event)
        if not file_path or not _is_image_path(file_path):
            return None
        if file_path in self._processed_paths or file_path in self._failed_paths:
            return None
        info = await self._lookup_file_info(file_path)
        if info is None or not validate_image_entry(info):
            self._failed_paths.add(file_path)
            return None
        parent = file_path.rsplit("/", 1)[0] if "/" in file_path else ""
        conjunto_id = await self._resolve_conjunto(parent)
        if conjunto_id is None:
            self._failed_paths.add(file_path)
            return None
        try:
            data = await self.client.get_file(file_path)
        except Exception as exc:
            logger.error("download falhou %s: %s", file_path, exc)
            self._failed_paths.add(file_path)
            return None
        content_hash = sha256_hex(data)
        # off the event loop: a burst of file_created events must not
        # block the shared loop for a multi-MB PIL parse each (the
        # webdav path already offloads; self-review r3)
        metadata = await asyncio.to_thread(extract_metadata, data)
        now = tz.utcnow()
        last_mod = info.get("last_modified")
        result = "created"
        with self.db.session() as s:
            imagem = s.get(Imagem, content_hash)
            if imagem is None:
                try:
                    s.add(
                        Imagem(
                            content_hash=content_hash,
                            nome_img=info.get("name", ""),
                            caminho_img=info.get("path", file_path),
                            metadados={
                                "nextcloud": {
                                    "file_id": info.get("file_id", ""),
                                    "etag": info.get("etag", ""),
                                    "content_type": info.get("content_type", ""),
                                    "size": info.get("content_length", 0),
                                    "last_modified": (
                                        last_mod.isoformat() if last_mod else None
                                    ),
                                },
                                "image": metadata,
                                "sync": {
                                    "sync_method": "activity_api",
                                    "sync_timestamp": now.isoformat(),
                                },
                            },
                            existe_no_nextcloud=True,
                            data_proc=now,
                            data_sinc=now,
                            id_cnj=conjunto_id,
                        )
                    )
                    s.flush()
                except IntegrityError:
                    s.rollback()
                    result = "updated"
            else:
                imagem.nome_img = info.get("name", "")
                imagem.caminho_img = info.get("path", file_path)
                imagem.existe_no_nextcloud = True
                imagem.data_sinc = now
                # a MOVED image follows its new conjunto (same fix as
                # webdav_sync._refresh_image; self-review r3)
                imagem.id_cnj = str(conjunto_id)
                result = "updated"
            s.commit()
        if self.on_image_bytes is not None:
            try:
                self.on_image_bytes(content_hash, data)
            except Exception:
                logger.exception("on_image_bytes hook falhou")
        self._processed_paths.add(file_path)
        return result

    def process_file_deleted(self, event: dict) -> bool:
        file_path = _event_path(event)
        if not file_path or not _is_image_path(file_path):
            return False
        with self.db.session() as s:
            imagem = (
                s.query(Imagem)
                .filter(Imagem.caminho_img == file_path.strip("/"))
                .first()
            )
            if imagem is None:
                return False
            imagem.existe_no_nextcloud = False
            imagem.data_sinc = tz.utcnow()
            s.commit()
        return True

    async def process_file_changed(self, event: dict) -> bool:
        file_path = _event_path(event)
        if not file_path or not _is_image_path(file_path):
            return False
        info = await self._lookup_file_info(file_path)
        if info is None:
            return False
        now = tz.utcnow()
        with self.db.session() as s:
            exists = (
                s.query(Imagem)
                .filter(Imagem.caminho_img == file_path.strip("/"))
                .first()
            ) is not None
        if not exists:
            return (await self.process_file_created(event)) is not None
        with self.db.session() as s:
            imagem = (
                s.query(Imagem)
                .filter(Imagem.caminho_img == file_path.strip("/"))
                .first()
            )
            imagem.nome_img = info.get("name", "")
            imagem.existe_no_nextcloud = True
            imagem.data_sinc = now
            meta = dict(imagem.metadados or {})
            last_mod = info.get("last_modified")
            meta.setdefault("nextcloud", {}).update(
                {
                    "etag": info.get("etag", ""),
                    "last_modified": last_mod.isoformat() if last_mod else None,
                }
            )
            imagem.metadados = meta
            s.commit()
        return True
