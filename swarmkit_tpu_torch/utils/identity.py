"""Random IDs (reference: identity/randomid.go — crockford base32 of 16 bytes).

The port's copy of the JAX package's `utils/identity.py`."""
from __future__ import annotations

import os

_ALPHABET = "0123456789abcdefghjkmnpqrstvwxyz"  # crockford base32, lowercase


def new_id() -> str:
    raw = int.from_bytes(os.urandom(16), "big")
    out = []
    for _ in range(25):
        out.append(_ALPHABET[raw & 31])
        raw >>= 5
    return "".join(reversed(out))


def new_secret_token(kind: str = "") -> str:
    """Join/unlock token (reference: ca/config.go GenerateJoinToken —
    'SWMTKN-1-<ca digest>-<secret>'; here the digest slot carries the kind
    marker until the CA layer fills in the real root digest)."""
    return f"SWMTKN-1-{kind or 'token'}-{new_id()}"
