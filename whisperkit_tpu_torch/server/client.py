"""A minimal client of the server's Audio API on `urllib` (the standard
library has no multipart encoder): `encode_multipart` builds a
multipart/form-data body, `post` sends one and returns (status, headers,
body bytes) whatever the status.
"""

from __future__ import annotations

import uuid
import urllib.error
import urllib.request
from typing import Optional, Sequence


def encode_multipart(
    fields: Sequence[tuple[str, str]], files: Sequence[tuple[str, str, bytes]] = ()
) -> tuple[str, bytes]:
    """(content type, body) for form `fields` [(name, value)] and `files`
    [(name, filename, bytes)]; a field name may repeat."""
    boundary = f"----whisperkit-{uuid.uuid4().hex}"
    out = bytearray()
    for name, value in fields:
        out += f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"\r\n\r\n'.encode()
        out += str(value).encode("utf-8") + b"\r\n"
    for name, filename, data in files:
        out += (
            f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; filename="{filename}"\r\n'
            "Content-Type: application/octet-stream\r\n\r\n"
        ).encode()
        out += data + b"\r\n"
    out += f"--{boundary}--\r\n".encode()
    return f"multipart/form-data; boundary={boundary}", bytes(out)


def post(
    url: str,
    fields: Sequence[tuple[str, str]] = (),
    files: Sequence[tuple[str, str, bytes]] = (),
    timeout: Optional[float] = None,
) -> tuple[int, dict, bytes]:
    """POST a multipart form; (status, headers, body)."""
    ctype, body = encode_multipart(fields, files)
    req = urllib.request.Request(url, data=body, method="POST", headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def get(url: str, timeout: Optional[float] = None) -> tuple[int, dict, bytes]:
    """GET; (status, headers, body)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()
