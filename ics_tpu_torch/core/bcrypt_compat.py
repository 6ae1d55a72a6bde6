"""bcrypt ``$2b$`` password *verification* — pure stdlib.

The reference stores bcrypt hashes (``app/core/utils.py:5-10``,
``requirements.txt:12`` pins the ``bcrypt`` wheel). ics_tpu_torch hashes new
passwords with scrypt (``core/security.py``), but adopting a live
reference database (``python -m ics_tpu_torch.db.adopt``) means every existing
``usuarios.senha_hash`` row is a bcrypt digest — without verification
support, adoption would lock out every user at first login.

This module implements bcrypt verification from the published algorithm
(Provos & Mazières, "A Future-Adaptable Password Scheme", USENIX 1999):

- Blowfish, with the P-array/S-box constants *computed* from the
  hexadecimal expansion of pi (their published definition) instead of an
  embedded table — the init self-checks the first word against 0x243f6a88.
- EksBlowfish expensive key setup (cost-parameterised salted rescheduling).
- The ``OrpheanBeholderScryDoubt`` 64x ECB checksum, bcrypt base64.

``$2b$``, ``$2a$`` and ``$2y$`` prefixes are accepted: for passwords up to
72 bytes (the only lengths any of the three can produce distinct digests
for in practice) the variants are computationally identical — the 2a/2b
split concerns a length-wraparound bug at >=255 bytes, and the key stream
only ever contributes its first 72 bytes to the schedule.

Verification is *slow by design* (that is bcrypt's point); a pure-Python
cost-12 check takes tens of seconds. When the host libcrypt supports
bcrypt (libxcrypt does; probed once at import), ``bcrypt_verify`` uses it
as a fast path and keeps the pure-Python path as the portable fallback.
Either way the caller should rehash to scrypt on first successful login
(``services/auth_service.py``) so the cost is paid once per adopted user.

Hashing new passwords as bcrypt is deliberately NOT offered: new
credentials use scrypt.
"""

from __future__ import annotations

import hmac
import re
import struct
from functools import lru_cache
from typing import List, Optional, Tuple

# --------------------------------------------------------------------------
# Optional fast path: CPython's ``crypt`` (glibc/libxcrypt). Deprecated in
# 3.12 and removed in 3.13 — treated strictly as an accelerator.
try:  # pragma: no cover - environment probe
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import crypt as _crypt

    # Full known-answer probe (the 22nd salt char is canonicalised by
    # libxcrypt, so a prefix check on the *setting* would false-negative).
    _PROBE = "$2b$04$abcdefghijklmnopqrstuughE8Ev8uGFaUgY2cNEySvxngrb/Jzdm"
    _HAVE_LIBCRYPT_BCRYPT = _crypt.crypt("password", _PROBE) == _PROBE
except Exception:  # pragma: no cover
    _crypt = None
    _HAVE_LIBCRYPT_BCRYPT = False


_HASH_RE = re.compile(
    r"^\$(2[aby])\$(\d{2})\$([./A-Za-z0-9]{22})([./A-Za-z0-9]{31})$"
)

_B64 = "./ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
_B64_INDEX = {c: i for i, c in enumerate(_B64)}

_MASK = 0xFFFFFFFF
_MAGIC = b"OrpheanBeholderScryDoubt"  # 24 bytes = three Blowfish blocks


def is_bcrypt_hash(stored: str) -> bool:
    return isinstance(stored, str) and _HASH_RE.match(stored) is not None


# --------------------------------------------------------------------------
# bcrypt base64 (distinct alphabet and no padding)


def _b64_decode(text: str, nbytes: int) -> bytes:
    acc = 0
    bits = 0
    out = bytearray()
    for ch in text:
        acc = (acc << 6) | _B64_INDEX[ch]
        bits += 6
        if bits >= 8:
            bits -= 8
            out.append((acc >> bits) & 0xFF)
    return bytes(out[:nbytes])


def _b64_encode(data: bytes) -> str:
    acc = 0
    bits = 0
    out = []
    for byte in data:
        acc = (acc << 8) | byte
        bits += 8
        while bits >= 6:
            bits -= 6
            out.append(_B64[(acc >> bits) & 0x3F])
    if bits:
        out.append(_B64[(acc << (6 - bits)) & 0x3F])
    return "".join(out)


# --------------------------------------------------------------------------
# Blowfish initial state = hexadecimal digits of pi (fractional part).
# 18 P words + 4*256 S words = 1042 words = 8336 hex digits, computed with
# Machin's formula in plain integer arithmetic (~1 s, cached for the
# process lifetime).


def _atan_inv(x: int, bits: int) -> int:
    """floor(atan(1/x) * 2^bits) via the alternating Gregory series."""
    power = (1 << bits) // x
    total = power
    x2 = x * x
    k = 0
    while power:
        power //= x2
        k += 1
        term = power // (2 * k + 1)
        total += term if k % 2 == 0 else -term
    return total


@lru_cache(maxsize=1)
def _initial_state() -> Tuple[Tuple[int, ...], ...]:
    nwords = 18 + 4 * 256
    bits = nwords * 32 + 128  # 128 guard bits
    pi = 16 * _atan_inv(5, bits) - 4 * _atan_inv(239, bits)
    frac = pi - (3 << bits)
    words = tuple(
        (frac >> (bits - 32 * (i + 1))) & _MASK for i in range(nwords)
    )
    if words[0] != 0x243F6A88 or words[1] != 0x85A308D3:
        raise RuntimeError("pi digit computation failed self-check")
    return (
        words[:18],
        words[18:274],
        words[274:530],
        words[530:786],
        words[786:1042],
    )


# --------------------------------------------------------------------------
# Core schedule. P/S are mutated in place; the encipher reads the
# partially-updated state exactly as the algorithm prescribes.


def _cyclic_words(stream: bytes, nwords: int) -> List[int]:
    """``nwords`` big-endian 32-bit words drawn cyclically from ``stream``."""
    n = len(stream)
    out = []
    j = 0
    for _ in range(nwords):
        w = 0
        for _ in range(4):
            w = (w << 8) | stream[j % n]
            j += 1
        out.append(w)
    return out


def _make_encipher(P, S0, S1, S2, S3):
    def encipher(l: int, r: int) -> Tuple[int, int]:
        l ^= P[0]
        # 16 Feistel rounds, unrolled in pairs; F(x) =
        # ((S0[a]+S1[b]) ^ S2[c]) + S3[d] mod 2^32
        r ^= (((((S0[l >> 24] + S1[(l >> 16) & 255]) & _MASK)
                ^ S2[(l >> 8) & 255]) + S3[l & 255]) & _MASK) ^ P[1]
        l ^= (((((S0[r >> 24] + S1[(r >> 16) & 255]) & _MASK)
                ^ S2[(r >> 8) & 255]) + S3[r & 255]) & _MASK) ^ P[2]
        r ^= (((((S0[l >> 24] + S1[(l >> 16) & 255]) & _MASK)
                ^ S2[(l >> 8) & 255]) + S3[l & 255]) & _MASK) ^ P[3]
        l ^= (((((S0[r >> 24] + S1[(r >> 16) & 255]) & _MASK)
                ^ S2[(r >> 8) & 255]) + S3[r & 255]) & _MASK) ^ P[4]
        r ^= (((((S0[l >> 24] + S1[(l >> 16) & 255]) & _MASK)
                ^ S2[(l >> 8) & 255]) + S3[l & 255]) & _MASK) ^ P[5]
        l ^= (((((S0[r >> 24] + S1[(r >> 16) & 255]) & _MASK)
                ^ S2[(r >> 8) & 255]) + S3[r & 255]) & _MASK) ^ P[6]
        r ^= (((((S0[l >> 24] + S1[(l >> 16) & 255]) & _MASK)
                ^ S2[(l >> 8) & 255]) + S3[l & 255]) & _MASK) ^ P[7]
        l ^= (((((S0[r >> 24] + S1[(r >> 16) & 255]) & _MASK)
                ^ S2[(r >> 8) & 255]) + S3[r & 255]) & _MASK) ^ P[8]
        r ^= (((((S0[l >> 24] + S1[(l >> 16) & 255]) & _MASK)
                ^ S2[(l >> 8) & 255]) + S3[l & 255]) & _MASK) ^ P[9]
        l ^= (((((S0[r >> 24] + S1[(r >> 16) & 255]) & _MASK)
                ^ S2[(r >> 8) & 255]) + S3[r & 255]) & _MASK) ^ P[10]
        r ^= (((((S0[l >> 24] + S1[(l >> 16) & 255]) & _MASK)
                ^ S2[(l >> 8) & 255]) + S3[l & 255]) & _MASK) ^ P[11]
        l ^= (((((S0[r >> 24] + S1[(r >> 16) & 255]) & _MASK)
                ^ S2[(r >> 8) & 255]) + S3[r & 255]) & _MASK) ^ P[12]
        r ^= (((((S0[l >> 24] + S1[(l >> 16) & 255]) & _MASK)
                ^ S2[(l >> 8) & 255]) + S3[l & 255]) & _MASK) ^ P[13]
        l ^= (((((S0[r >> 24] + S1[(r >> 16) & 255]) & _MASK)
                ^ S2[(r >> 8) & 255]) + S3[r & 255]) & _MASK) ^ P[14]
        r ^= (((((S0[l >> 24] + S1[(l >> 16) & 255]) & _MASK)
                ^ S2[(l >> 8) & 255]) + S3[l & 255]) & _MASK) ^ P[15]
        l ^= (((((S0[r >> 24] + S1[(r >> 16) & 255]) & _MASK)
                ^ S2[(r >> 8) & 255]) + S3[r & 255]) & _MASK) ^ P[16]
        return r ^ P[17], l

    return encipher


def _expand_state(P, boxes, encipher, key_words, salt_words: Optional[List[int]]):
    """One EksBlowfish ExpandKey pass: ``salt_words`` is the four-word salt
    (salted pass) or None (the ``Expand0State`` zero-salt pass)."""
    for i in range(18):
        P[i] ^= key_words[i]
    l = r = 0
    if salt_words is None:
        i = 0
        while i < 18:
            l, r = encipher(l, r)
            P[i] = l
            P[i + 1] = r
            i += 2
        for box in boxes:
            i = 0
            while i < 256:
                l, r = encipher(l, r)
                box[i] = l
                box[i + 1] = r
                i += 2
    else:
        s0, s1, s2, s3 = salt_words
        k = 0  # global pair index: even pairs xor (s0,s1), odd (s2,s3)
        i = 0
        while i < 18:
            if k & 1:
                l, r = encipher(l ^ s2, r ^ s3)
            else:
                l, r = encipher(l ^ s0, r ^ s1)
            k += 1
            P[i] = l
            P[i + 1] = r
            i += 2
        for box in boxes:
            i = 0
            while i < 256:
                if k & 1:
                    l, r = encipher(l ^ s2, r ^ s3)
                else:
                    l, r = encipher(l ^ s0, r ^ s1)
                k += 1
                box[i] = l
                box[i + 1] = r
                i += 2


def _hashpass(password: bytes, cost: int, salt: bytes) -> bytes:
    """EksBlowfishSetup + 64x ECB of the magic block; returns the 23
    checksum bytes that bcrypt encodes."""
    # Key stream: password + NUL, capped at 72 password bytes. Only the
    # first 72 stream bytes ever reach the schedule (18 P words), so the
    # 2a/2b length-handling differences are unobservable here.
    key = password[:72] + b"\x00"
    key_words = _cyclic_words(key, 18)
    salt_key_words = _cyclic_words(salt, 18)  # salt used AS key material
    salt_words = list(struct.unpack(">4I", salt))

    p0, s0, s1, s2, s3 = _initial_state()
    P = list(p0)
    boxes = [list(s0), list(s1), list(s2), list(s3)]
    encipher = _make_encipher(P, *boxes)

    _expand_state(P, boxes, encipher, key_words, salt_words)
    for _ in range(1 << cost):
        _expand_state(P, boxes, encipher, key_words, None)
        _expand_state(P, boxes, encipher, salt_key_words, None)

    data = list(struct.unpack(">6I", _MAGIC))
    for _ in range(64):
        for b in range(0, 6, 2):
            data[b], data[b + 1] = encipher(data[b], data[b + 1])
    return struct.pack(">6I", *data)[:23]


def bcrypt_hash_pure(password: str, setting: str) -> Optional[str]:
    """Full modular-crypt digest for ``password`` under ``setting`` (a
    ``$2x$NN$<22-char-salt>`` prefix or a complete hash). None if the
    setting is unparseable. Exposed for verification/tests — new
    credentials are hashed with scrypt, never bcrypt."""
    m = re.match(r"^\$(2[aby])\$(\d{2})\$([./A-Za-z0-9]{22})", setting)
    if not m:
        return None
    minor, cost_s, salt_s = m.groups()
    cost = int(cost_s)
    if not 4 <= cost <= 31:
        return None
    salt = _b64_decode(salt_s, 16)
    checksum = _hashpass(password.encode("utf-8"), cost, salt)
    return f"${minor}${cost_s}${salt_s}{_b64_encode(checksum)}"


def _salt_is_canonical(salt_s: str) -> bool:
    """True when the 22-char salt round-trips through decode/encode.

    22 chars x 6 bits = 132 bits for a 16-byte (128-bit) salt, so the last
    char's low 4 bits are padding. Canonical encoders zero them, but
    crypt_blowfish/pyca bcrypt *accept* settings with nonzero padding and
    echo them verbatim into the digest — while libxcrypt canonicalises the
    salt in its output. For such a hash the fast path's string compare
    would reject the CORRECT password; the pure path (verbatim salt
    re-encode) must be used instead."""
    return _b64_encode(_b64_decode(salt_s, 16)) == salt_s


def bcrypt_verify(password: str, stored: str) -> bool:
    """Constant-time-compare verification of a ``$2a/2b/2y`` hash."""
    m = _HASH_RE.match(stored) if isinstance(stored, str) else None
    if m is None:
        return False
    # Fast path only for canonical salts: libxcrypt canonicalises the
    # 22nd salt char in its output, so a mismatch there would be
    # indistinguishable from a wrong password. Non-canonical hashes
    # (foreign tools echo the setting verbatim) take the pure path, whose
    # verbatim salt re-encode reproduces the stored string exactly.
    if _HAVE_LIBCRYPT_BCRYPT and _salt_is_canonical(m.group(3)):
        try:
            computed = _crypt.crypt(password, stored)
        except Exception:
            computed = None
        if computed and computed.startswith("$2"):
            return hmac.compare_digest(computed, stored)
        # fall through to the pure path on any oddity
    computed = bcrypt_hash_pure(password, stored)
    if computed is None:
        return False
    return hmac.compare_digest(computed, stored)
