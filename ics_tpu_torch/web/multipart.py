"""Minimal multipart/form-data parser (RFC 7578 subset).

Supports text fields and file fields (held in memory — upload sizes here are
bounded by ``settings.MAX_FILE_SIZE``, matching the reference's in-memory
handling of uploads in ``app/api/routes/images.py:18-101``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class UploadFile:
    filename: str
    content_type: str
    data: bytes

    @property
    def size(self) -> int:
        return len(self.data)

    async def read(self) -> bytes:
        return self.data


@dataclass
class FormData:
    fields: dict[str, str] = field(default_factory=dict)
    files: list[tuple[str, UploadFile]] = field(default_factory=list)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self.fields.get(key, default)

    def getfiles(self, key: str) -> list[UploadFile]:
        return [f for k, f in self.files if k == key]


def _parse_content_disposition(value: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for part in value.split(";"):
        part = part.strip()
        if "=" in part:
            k, _, v = part.partition("=")
            out[k.strip()] = v.strip().strip('"')
        else:
            out[part] = ""
    return out


def parse_multipart(body: bytes, content_type: str) -> FormData:
    boundary = None
    for piece in content_type.split(";"):
        piece = piece.strip()
        if piece.startswith("boundary="):
            boundary = piece[len("boundary="):].strip('"')
            break
    if not boundary:
        raise ValueError("multipart body without boundary")
    delim = b"--" + boundary.encode()
    form = FormData()
    for raw_part in body.split(delim):
        # strip exactly ONE protocol CRLF from each side — the part's own
        # payload may legitimately begin/end with CR/LF bytes and a greedy
        # strip would corrupt the content (and its content-hash)
        part = raw_part
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" in part:
            raw_headers, _, content = part.partition(b"\r\n\r\n")
        else:
            continue
        headers: dict[str, str] = {}

        def _header_text(b: bytes) -> str:
            # browsers send Content-Disposition filenames as raw UTF-8
            # (HTML spec): decode that first; fall back to latin-1 (the
            # HTTP header byte charset — lossless) so a stray byte can
            # never 500 the request
            try:
                return b.decode("utf-8")
            except UnicodeDecodeError:
                return b.decode("latin-1")

        for line in raw_headers.split(b"\r\n"):
            if b":" in line:
                k, _, v = line.partition(b":")
                headers[_header_text(k).strip().lower()] = (
                    _header_text(v).strip()
                )
        disp = _parse_content_disposition(headers.get("content-disposition", ""))
        name = disp.get("name", "")
        if "filename" in disp:
            form.files.append(
                (
                    name,
                    UploadFile(
                        filename=disp.get("filename", ""),
                        content_type=headers.get(
                            "content-type", "application/octet-stream"
                        ),
                        data=content,
                    ),
                )
            )
        else:
            form.fields[name] = content.decode("utf-8", "replace")
    return form


def parse_urlencoded(body: bytes) -> FormData:
    from urllib.parse import parse_qsl

    form = FormData()
    for k, v in parse_qsl(body.decode("utf-8", "replace"), keep_blank_values=True):
        form.fields[k] = v
    return form
