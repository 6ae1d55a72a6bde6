"""Domain validators: CPF check digits, full-name, password strength.

Behavioral parity with the reference (``app/core/utils.py:13-37``):
- CPF: 11 digits, not all equal, both check digits valid.
- Nome: at least two words.
- Senha: >=8 chars with upper, lower and digit.
"""

from __future__ import annotations

import re


def validar_cpf(cpf: str) -> bool:
    digits = re.sub(r"\D", "", cpf or "")
    if len(digits) != 11 or digits == digits[0] * 11:
        return False
    nums = [int(c) for c in digits]
    for pos in (9, 10):
        weights = range(pos + 1, 1, -1)
        total = sum(n * w for n, w in zip(nums[:pos], weights))
        check = (total * 10) % 11
        if check == 10:
            check = 0
        if check != nums[pos]:
            return False
    return True


# RFC 5321/5322 dot-atom syntax, matching what pydantic's EmailStr (the
# email-validator package, reference app/schemas/auth_schema.py:47,64,92)
# accepts with deliverability checks off: dot-atom local part, hostname-shaped
# domain with at least one dot and an alphabetic TLD.
_ATEXT = r"[A-Za-z0-9!#$%&'*+/=?^_`{|}~\-]"
_EMAIL_RE = re.compile(
    rf"^{_ATEXT}+(?:\.{_ATEXT}+)*"  # local: dot-atom (no leading/trailing/double dots)
    r"@"
    r"(?:[A-Za-z0-9](?:[A-Za-z0-9\-]{0,61}[A-Za-z0-9])?\.)+"  # domain labels
    r"[A-Za-z]{2,63}$"  # TLD
)


def validar_email(email: str) -> bool:
    if not email or len(email) > 254:
        return False
    local, _, domain = email.partition("@")
    if len(local) > 64 or len(domain) > 253:
        return False
    return _EMAIL_RE.match(email) is not None


def validar_nome(nome: str) -> bool:
    return len((nome or "").strip().split()) >= 2


def validar_forca_senha(senha: str) -> bool:
    if not senha or len(senha) < 8:
        return False
    return (
        re.search(r"[A-Z]", senha) is not None
        and re.search(r"[a-z]", senha) is not None
        and re.search(r"\d", senha) is not None
    )
