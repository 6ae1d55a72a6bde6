"""Password hashing and JWT — pure stdlib.

The reference used bcrypt + python-jose (``app/core/utils.py:5-10``,
``app/services/auth_service.py:40-59``); neither is installed here, so this
module implements:

- password hashing with ``hashlib.scrypt`` (salted, constant-time compare)
- HS256 JSON Web Tokens (RFC 7519 subset: ``exp`` validation) with
  ``hmac``/``hashlib``

Token claims match the reference contract: ``sub`` (user id), ``email``,
``nome``, ``tipo``, ``exp``.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import json
import os
import time
from typing import Any, Optional

_SCRYPT_N = 2**14
_SCRYPT_R = 8
_SCRYPT_P = 1
_SALT_LEN = 16
_DKLEN = 32


class TokenError(Exception):
    """Raised when a JWT is malformed, tampered with, or expired."""


def hash_password(password: str) -> str:
    salt = os.urandom(_SALT_LEN)
    dk = hashlib.scrypt(
        password.encode("utf-8"), salt=salt,
        n=_SCRYPT_N, r=_SCRYPT_R, p=_SCRYPT_P, dklen=_DKLEN,
    )
    return "scrypt${}${}${}${}${}".format(
        _SCRYPT_N, _SCRYPT_R, _SCRYPT_P,
        base64.b64encode(salt).decode(), base64.b64encode(dk).decode(),
    )


def verify_password(password: str, stored: str) -> bool:
    try:
        if stored.startswith("$2"):
            # bcrypt digest from an adopted reference database
            # (reference ``app/core/utils.py:5-10``); verified here, and
            # rehashed to scrypt on first successful login by
            # ``services/auth_service.authenticate_user``.
            from ics_tpu_torch.core.bcrypt_compat import bcrypt_verify

            return bcrypt_verify(password, stored)
        scheme, n, r, p, salt_b64, dk_b64 = stored.split("$")
        if scheme != "scrypt":
            return False
        salt = base64.b64decode(salt_b64)
        expected = base64.b64decode(dk_b64)
        dk = hashlib.scrypt(
            password.encode("utf-8"), salt=salt,
            n=int(n), r=int(r), p=int(p), dklen=len(expected),
        )
        return hmac.compare_digest(dk, expected)
    except Exception:
        return False


# Hash verification must not run on the event loop: scrypt costs ~25 ms,
# and the pure-Python bcrypt fallback for adopted reference credentials
# (no libxcrypt / Python>=3.13) costs SECONDS of CPU at the reference's
# cost 12.  On the single-core host a synchronous check would stall every
# in-flight request — including /health — and with LOGIN_RATE_LIMIT off by
# default (reference parity) that is an unauthenticated DoS: any wrong
# password against an adopted user replays the full cost.  The gate below
# additionally serializes bcrypt checks so a burst of login attempts
# queues instead of piling N multi-second computations onto one core.
_bcrypt_gate = asyncio.Semaphore(1)


async def verify_password_async(password: str, stored: str) -> bool:
    """``verify_password`` off the event loop (use this from routes)."""
    if isinstance(stored, str) and stored.startswith("$2"):
        async with _bcrypt_gate:
            return await asyncio.to_thread(verify_password, password, stored)
    return await asyncio.to_thread(verify_password, password, stored)


def password_needs_rehash(stored: str) -> bool:
    """True when a stored credential should be upgraded to the current
    scheme (scrypt) on the next successful login — i.e. any bcrypt hash
    carried over from an adopted reference database."""
    return isinstance(stored, str) and stored.startswith("$2")


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _b64url_decode(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def jwt_encode(claims: dict[str, Any], secret: str, algorithm: str = "HS256") -> str:
    if algorithm != "HS256":
        raise ValueError(f"unsupported algorithm: {algorithm}")
    header = {"alg": "HS256", "typ": "JWT"}
    signing_input = (
        _b64url(json.dumps(header, separators=(",", ":")).encode())
        + "."
        + _b64url(json.dumps(claims, separators=(",", ":"), default=str).encode())
    )
    sig = hmac.new(secret.encode(), signing_input.encode(), hashlib.sha256).digest()
    return signing_input + "." + _b64url(sig)


def jwt_decode(
    token: str, secret: str, algorithm: str = "HS256", verify_exp: bool = True
) -> dict[str, Any]:
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
        header = json.loads(_b64url_decode(header_b64))
        if header.get("alg") != algorithm or algorithm != "HS256":
            raise TokenError("unexpected algorithm")
        signing_input = f"{header_b64}.{payload_b64}".encode()
        expected = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
        if not hmac.compare_digest(expected, _b64url_decode(sig_b64)):
            raise TokenError("signature mismatch")
        claims = json.loads(_b64url_decode(payload_b64))
    except TokenError:
        raise
    except Exception:
        raise TokenError("malformed token")
    if verify_exp:
        exp = claims.get("exp")
        try:
            expired = exp is None or float(exp) < time.time()
        except (TypeError, ValueError):
            # a correctly-signed token with a non-numeric exp (another
            # producer sharing the secret serialized a datetime) must be
            # a 401 TokenError, not a 500 ValueError (self-review r3)
            raise TokenError("malformed exp claim")
        if expired:
            raise TokenError("token expired")
    return claims


def sha256_hex(data: bytes) -> str:
    """Content-hash identity used throughout the system (reference
    ``webdav_sync.py:59``)."""
    return hashlib.sha256(data).hexdigest()
