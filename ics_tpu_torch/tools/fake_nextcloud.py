"""A fake NextCloud server (WebDAV PROPFIND, file GET and the Activity API)
on the port's own web framework.

The same double as the repository's test helper ``tests/fake_nextcloud.py``,
built on ``ics_tpu_torch.web``: state is a dict of folders -> files; callers
mutate it and record activity events. In process, a sync client talks to
``make_fake_nextcloud(state)`` through ``httpx.ASGITransport``; as a
program it serves a directory tree (each subdirectory a folder, each image
file in it a file) on a local TCP port:

    python -m ics_tpu_torch.tools.fake_nextcloud --root DIR --port P [--gate FILE]

The sync engine then reaches it with ``NEXTCLOUD_BASE_URL=http://127.0.0.1:P``,
``NEXTCLOUD_USERNAME=tester`` and ``NEXTCLOUD_USER_PATH=/files/tester``.
With ``--gate FILE`` every request waits until FILE exists (at most
``GATE_MAX_S``, under the sync client's 60 s timeout), so that a caller can
start a server whose initial sync begins at startup and still choose when
that sync's traffic starts (``chip_smoke.py`` [7] counts kernel launches over
the sync alone).
"""

from __future__ import annotations

import argparse
import asyncio
import io
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional
from xml.sax.saxutils import escape

import numpy as np
from PIL import Image as PILImage

from ics_tpu_torch.web import App, JSONResponse, Request, Response, Router

USER_PATH = "/files/tester"
DAV_PREFIX = f"/remote.php/dav{USER_PATH}"
CONTENT_TYPES = {".jpg": "image/jpeg", ".jpeg": "image/jpeg", ".png": "image/png"}
GATE_MAX_S = 50.0


def make_jpeg(seed: int, size=(64, 48)) -> bytes:
    rng = np.random.default_rng(seed)
    img = PILImage.fromarray(
        rng.integers(0, 256, (size[1], size[0], 3), np.uint8)
    )
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=85)
    return buf.getvalue()


@dataclass
class FakeFile:
    name: str
    data: bytes
    file_id: str
    content_type: str = "image/jpeg"
    etag: str = "v1"


@dataclass
class FakeState:
    # folder name -> {filename: FakeFile}
    folders: dict = field(default_factory=dict)
    folder_ids: dict = field(default_factory=dict)
    events: list = field(default_factory=list)
    next_id: int = 1000
    fail_webdav: bool = False
    fail_activity: bool = False
    gate: Optional[Path] = None  # requests wait until this file exists

    async def wait_for_gate(self) -> None:
        deadline = time.monotonic() + GATE_MAX_S
        while self.gate is not None and not self.gate.exists() \
                and time.monotonic() < deadline:
            await asyncio.sleep(0.02)

    def new_id(self) -> str:
        self.next_id += 1
        return str(self.next_id)

    def add_folder(self, name: str) -> str:
        if name not in self.folders:
            self.folders[name] = {}
            self.folder_ids[name] = self.new_id()
        return self.folder_ids[name]

    def add_image(self, folder: str, name: str, data: bytes,
                  content_type: str = "image/jpeg") -> FakeFile:
        self.add_folder(folder)
        f = FakeFile(name=name, data=data, file_id=self.new_id(),
                     content_type=content_type)
        self.folders[folder][name] = f
        return f

    def record_event(self, type_: str, object_name: str) -> None:
        self.events.append(
            {
                "activity_id": len(self.events) + 1,
                "type": type_,
                "object_type": "files",
                "object_name": object_name,
                "datetime": time.time(),
            }
        )

    @classmethod
    def from_directory(cls, root: Path) -> "FakeState":
        """One folder per subdirectory of ``root`` (sorted), one file per
        JPEG or PNG in it."""
        state = cls()
        for folder in sorted(p for p in Path(root).iterdir() if p.is_dir()):
            state.add_folder(folder.name)
            for path in sorted(folder.iterdir()):
                ctype = CONTENT_TYPES.get(path.suffix.lower())
                if ctype is not None:
                    state.add_image(folder.name, path.name, path.read_bytes(), ctype)
        return state


def _propfind_entry(href: str, name: str, is_dir: bool, file_id: str,
                    content_type: str = "", length: int = 0,
                    etag: str = "") -> str:
    resourcetype = "<d:resourcetype><d:collection/></d:resourcetype>" if is_dir else "<d:resourcetype/>"
    ctype = f"<d:getcontenttype>{escape(content_type)}</d:getcontenttype>" if content_type else ""
    return f"""
  <d:response>
    <d:href>{escape(href)}</d:href>
    <d:propstat>
      <d:prop>
        <d:displayname>{escape(name)}</d:displayname>
        {ctype}
        <d:getcontentlength>{length}</d:getcontentlength>
        <d:getlastmodified>Mon, 01 Jun 2026 10:00:00 GMT</d:getlastmodified>
        {resourcetype}
        <d:getetag>"{escape(etag or file_id)}"</d:getetag>
        <oc:fileid>{escape(file_id)}</oc:fileid>
      </d:prop>
      <d:status>HTTP/1.1 200 OK</d:status>
    </d:propstat>
  </d:response>"""


def make_fake_nextcloud(state: FakeState) -> App:
    app = App(title="fake-nextcloud")
    router = Router()

    @router.route("/remote.php/dav/files/tester", ["PROPFIND"])
    @router.route("/remote.php/dav/files/tester/{path:path}", ["PROPFIND"])
    async def propfind(request: Request):
        await state.wait_for_gate()
        if state.fail_webdav:
            return Response(b"down", 503)
        path = request.path_params.get("path", "").strip("/")
        entries = [
            _propfind_entry(f"{DAV_PREFIX}/{path}".rstrip("/") + "/",
                            path or "tester", True,
                            state.folder_ids.get(path, "root"))
        ]
        if path == "":
            for fname, fid in state.folder_ids.items():
                entries.append(
                    _propfind_entry(f"{DAV_PREFIX}/{fname}/", fname, True, fid)
                )
        elif path in state.folders:
            for f in state.folders[path].values():
                entries.append(
                    _propfind_entry(
                        f"{DAV_PREFIX}/{path}/{f.name}", f.name, False,
                        f.file_id, f.content_type, len(f.data), f.etag,
                    )
                )
        else:
            return Response(b"not found", 404)
        xml = (
            '<?xml version="1.0"?>\n'
            '<d:multistatus xmlns:d="DAV:" xmlns:oc="http://owncloud.org/ns">'
            + "".join(entries)
            + "\n</d:multistatus>"
        )
        return Response(xml.encode(), 207, media_type="application/xml")

    @router.get("/remote.php/dav/files/tester/{path:path}")
    async def get_file(request: Request):
        await state.wait_for_gate()
        if state.fail_webdav:
            return Response(b"down", 503)
        path = request.path_params["path"].strip("/")
        folder, _, name = path.rpartition("/")
        f = state.folders.get(folder, {}).get(name)
        if f is None:
            return Response(b"not found", 404)
        return Response(f.data, 200, media_type=f.content_type)

    @router.get("/ocs/v2.php/apps/activity/api/v2/activity")
    async def activity(request: Request):
        await state.wait_for_gate()
        if state.fail_activity:
            return Response(b"down", 503)
        # NextCloud semantics: ``since`` is the last-seen activity ID; the
        # default sort is desc (newest first) and pages move backward through
        # history under it, so the client must send sort=asc
        since = int(float(request.query_params.get("since", 0) or 0))
        limit = int(request.query_params.get("limit", 200) or 200)
        sort = (request.query_params.get("sort") or "desc").lower()
        if sort == "asc":
            events = [e for e in state.events if e["activity_id"] > since]
            events = sorted(events, key=lambda e: e["activity_id"])[:limit]
        else:
            events = [e for e in state.events if e["activity_id"] < since] \
                if since else list(state.events)
            events = sorted(events, key=lambda e: -e["activity_id"])[:limit]
        return JSONResponse({"ocs": {"data": events}})

    app.include_router(router)
    return app


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, required=True,
                        help="directory whose subdirectories are the folders")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--gate", type=Path, default=None,
                        help="answer nothing until this file exists")
    args = parser.parse_args()
    from ics_tpu_torch.web.server import run

    state = FakeState.from_directory(args.root)
    state.gate = args.gate
    run(make_fake_nextcloud(state), args.host, args.port)


if __name__ == "__main__":
    main()
