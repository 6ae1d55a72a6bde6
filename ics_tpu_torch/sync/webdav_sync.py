"""WebDAV full-scan sync — ground-truth reconciliation
(reference: ``app/services/webdav_sync.py``).

Per folder: upsert ``ConjuntoImagens`` by persistent ``file_id``; list
images; download each, SHA-256 it, extract PIL metadata; upsert ``Imagem``
by content hash in batches of ``NEXTCLOUD_SYNC_BATCH_SIZE`` with a commit
per batch and duplicate-hash merge; tombstone DB rows missing from
NextCloud (never hard-delete).

Net-new vs reference: each downloaded image's bytes can be handed to the
GPU ingestion buffer (``on_image_bytes`` hook) so sync doubles as the
inference pipeline's data front (BASELINE north star).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable, Optional

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.core.config import settings
from ics_tpu_torch.core.security import sha256_hex
from ics_tpu_torch.db.engine import Database, IntegrityError
from ics_tpu_torch.db.models import ConjuntoImagens, Imagem
from ics_tpu_torch.runtime.decode import image_metadata
from ics_tpu_torch.sync.nextcloud_client import (
    IMAGE_EXTENSIONS as ALLOWED_EXTENSIONS,
    IMAGE_MIMES as ALLOWED_MIMES,
    NextCloudClient,
)

logger = logging.getLogger(__name__)


def validate_image_entry(info: dict) -> bool:
    """Extension must match; content-type must match when the server sent
    one (some WebDAV servers omit getcontenttype — requiring it would
    silently skip those files forever)."""
    name = (info.get("name") or "").lower()
    ctype = (info.get("content_type") or "").lower()
    if not any(name.endswith(ext) for ext in ALLOWED_EXTENSIONS):
        return False
    return not ctype or any(mime in ctype for mime in ALLOWED_MIMES)


def extract_metadata(data: bytes) -> dict:
    try:
        return image_metadata(data)
    except Exception as exc:
        logger.warning("erro ao extrair metadados: %s", exc)
        return {}


class WebDAVSync:
    def __init__(
        self,
        client: NextCloudClient,
        db: Database,
        on_image_bytes: Optional[Callable[[str, bytes], None]] = None,
    ):
        self.client = client
        self.db = db
        self.on_image_bytes = on_image_bytes

    async def sync_all_folders(self) -> dict[str, Any]:
        stats = {
            "folders_processed": 0, "folders_created": 0, "folders_updated": 0,
            "images_processed": 0, "images_created": 0, "images_updated": 0,
            "images_marked_removed": 0, "errors": [],
        }
        root_items = await self.client.list_folder("", depth=1)
        folders = self.client.filter_folders(root_items)
        for folder in folders:
            try:
                folder_stats = await self.sync_folder(folder)
                stats["folders_processed"] += 1
                for key in (
                    "folders_created", "folders_updated", "images_processed",
                    "images_created", "images_updated", "images_marked_removed",
                ):
                    stats[key] += folder_stats.get(key, 0)
            except Exception as exc:
                # per-folder error isolation: continue with the next folder
                msg = f"Erro ao sincronizar pasta {folder.get('name')}: {exc}"
                logger.error(msg)
                stats["errors"].append(msg)
        self._mark_missing_folders(folders)
        return stats

    async def sync_folder(self, folder_info: dict) -> dict[str, Any]:
        stats = {
            "folders_created": 0, "folders_updated": 0, "images_processed": 0,
            "images_created": 0, "images_updated": 0, "images_marked_removed": 0,
        }
        file_id = folder_info.get("file_id") or ""
        if not file_id:
            logger.warning("pasta %s sem file_id; pulando", folder_info.get("name"))
            return stats
        now = tz.utcnow()
        with self.db.session() as s:
            conjunto = (
                s.query(ConjuntoImagens)
                .filter(ConjuntoImagens.file_id == file_id)
                .first()
            )
            if conjunto is None:
                conjunto = ConjuntoImagens(
                    nome_conj=folder_info.get("name", ""),
                    caminho_conj=folder_info.get("path", ""),
                    file_id=file_id,
                    imagens_sincronizadas=False,
                    existe_no_nextcloud=True,
                    data_proc=now,
                    data_sinc=now,
                )
                s.add(conjunto)
                stats["folders_created"] += 1
            else:
                conjunto.nome_conj = folder_info.get("name", "")
                conjunto.caminho_conj = folder_info.get("path", "")
                conjunto.existe_no_nextcloud = True
                conjunto.data_sinc = now
                stats["folders_updated"] += 1
            s.commit()
            conjunto_id = conjunto.id_cnj

        img_stats = await self.sync_images_in_folder(
            folder_info.get("path", ""), conjunto_id
        )
        for key, value in img_stats.items():
            stats[key] = stats.get(key, 0) + value

        # crash-safety flag: only set after the folder fully synced
        with self.db.session() as s:
            conjunto = s.get(ConjuntoImagens, conjunto_id)
            conjunto.imagens_sincronizadas = True
            s.commit()
        return stats

    async def sync_images_in_folder(
        self, folder_path: str, conjunto_id: str
    ) -> dict[str, int]:
        stats = {
            "images_processed": 0, "images_created": 0,
            "images_updated": 0, "images_marked_removed": 0,
        }
        items = await self.client.list_folder(folder_path, depth=1)
        images = self.client.filter_images(items)
        batch_size = settings.NEXTCLOUD_SYNC_BATCH_SIZE
        for i in range(0, len(images), batch_size):
            batch = images[i:i + batch_size]
            batch_stats = await self._process_image_batch(batch, conjunto_id)
            stats["images_processed"] += batch_stats["processed"]
            stats["images_created"] += batch_stats["created"]
            stats["images_updated"] += batch_stats["updated"]
        stats["images_marked_removed"] = self._mark_removed_images(
            conjunto_id, images
        )
        return stats

    async def _process_image_batch(
        self, images: list[dict], conjunto_id: str
    ) -> dict[str, int]:
        stats = {"processed": 0, "created": 0, "updated": 0}
        now = tz.utcnow()
        # per image: download/hash/decode with NO open DB transaction
        # (holding a write txn across 60 s downloads would lock out every
        # other writer), then ONE short upsert+commit, then the GPU hook.
        # The hook fires AFTER the commit: classify-on-sync's suggestion
        # INSERT carries an FK to imagens — firing at download time raced
        # the commit and the suggestion was silently lost on the FK
        # violation (self-review r3; the activity path already ordered it
        # this way).
        for info in images:
            if not validate_image_entry(info):
                continue
            try:
                data = await self.client.get_file(info["path"])
            except Exception as exc:
                logger.error("download falhou %s: %s", info.get("path"), exc)
                continue
            content_hash = sha256_hex(data)
            metadata = await asyncio.to_thread(extract_metadata, data)
            stats["processed"] += 1
            with self.db.session() as s:
                self._upsert_image(
                    s, content_hash, info, metadata, conjunto_id, now, stats
                )
                s.commit()
            if self.on_image_bytes is not None:
                try:
                    self.on_image_bytes(content_hash, data)
                except Exception:
                    logger.exception("on_image_bytes hook falhou")
        return stats

    def _upsert_image(
        self, s, content_hash: str, info: dict, metadata: dict,
        conjunto_id: str, now, stats: dict,
    ) -> None:
        last_mod = info.get("last_modified")
        nextcloud_meta = {
            "file_id": info.get("file_id", ""),
            "etag": info.get("etag", ""),
            "content_type": info.get("content_type", ""),
            "size": info.get("content_length", 0),
            "last_modified": last_mod.isoformat() if last_mod else None,
        }
        imagem = s.get(Imagem, content_hash)
        if imagem is None:
            try:
                s.add(
                    Imagem(
                        content_hash=content_hash,
                        nome_img=info.get("name", ""),
                        caminho_img=info.get("path", ""),
                        metadados={
                            "nextcloud": nextcloud_meta,
                            "image": metadata,
                            "sync": {
                                "sync_method": "webdav",
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
                stats["created"] += 1
            except IntegrityError:
                s.rollback()
                imagem = s.get(Imagem, content_hash)
                if imagem is not None:
                    self._refresh_image(
                        imagem, info, nextcloud_meta, now, conjunto_id
                    )
                    stats["updated"] += 1
        else:
            self._refresh_image(imagem, info, nextcloud_meta, now, conjunto_id)
            stats["updated"] += 1

    @staticmethod
    def _refresh_image(imagem: Imagem, info: dict, nextcloud_meta: dict, now,
                       conjunto_id: Optional[str] = None):
        imagem.nome_img = info.get("name", "")
        imagem.caminho_img = info.get("path", "")
        imagem.existe_no_nextcloud = True
        imagem.data_sinc = now
        if conjunto_id is not None:
            # an image MOVED between folders must follow its new conjunto
            # — keeping the old id_cnj made _mark_removed_images tombstone
            # it on every scan of the old folder (self-review r3)
            imagem.id_cnj = str(conjunto_id)
        meta = dict(imagem.metadados or {})
        meta.setdefault("nextcloud", {}).update(nextcloud_meta)
        imagem.metadados = meta

    def _mark_removed_images(self, conjunto_id: str, current_images: list[dict]) -> int:
        current_ids = {i.get("file_id") for i in current_images if i.get("file_id")}
        removed = 0
        now = tz.utcnow()
        with self.db.session() as s:
            rows = (
                s.query(Imagem)
                .filter(
                    Imagem.id_cnj == str(conjunto_id),
                    Imagem.existe_no_nextcloud == True,  # noqa: E712
                )
                .all()
            )
            for imagem in rows:
                file_id = (imagem.metadados or {}).get("nextcloud", {}).get("file_id")
                if file_id and file_id not in current_ids:
                    imagem.existe_no_nextcloud = False
                    imagem.data_sinc = now
                    removed += 1
            s.commit()
        return removed

    def _mark_missing_folders(self, current_folders: list[dict]) -> int:
        current_ids = {f.get("file_id") for f in current_folders if f.get("file_id")}
        now = tz.utcnow()
        removed = 0
        with self.db.session() as s:
            rows = (
                s.query(ConjuntoImagens)
                .filter(ConjuntoImagens.existe_no_nextcloud == True)  # noqa: E712
                .all()
            )
            for pasta in rows:
                # the scan only lists ROOT folders (depth 1); nested
                # conjuntos created via Activity events are invisible here
                # and must not be tombstoned by their absence
                if "/" in (pasta.caminho_conj or "").strip("/"):
                    continue
                if pasta.file_id not in current_ids:
                    pasta.existe_no_nextcloud = False
                    pasta.data_sinc = now
                    s.execute(
                        "UPDATE imagens SET existe_no_nextcloud = 0, data_sinc = ? "
                        "WHERE id_cnj = ?",
                        [now.isoformat(), pasta.id_cnj],
                    )
                    removed += 1
            s.commit()
        return removed
