"""Authentication tokens for aggregator-to-aggregator and collector requests.

reference: core/src/auth_tokens.rs:26 (AuthenticationToken), :335
(AuthenticationTokenHash — SHA-256 digests compared in constant time).
"""

from __future__ import annotations

import hashlib
import hmac
import os
from dataclasses import dataclass, field

from ..messages.dap import _b64url, _unb64url

DAP_AUTH_HEADER = "DAP-Auth-Token"
AUTHORIZATION_HEADER = "Authorization"

_MAX_DAP_AUTH_TOKEN_LEN = 256


def _is_bearer_token_char(c: str) -> bool:
    return c.isalnum() or c in "-._~+/"


@dataclass(frozen=True)
class AuthenticationToken:
    """Bearer ("Authorization: Bearer x") or DapAuth ("DAP-Auth-Token: x")."""

    BEARER = "Bearer"
    DAP_AUTH = "DapAuth"

    kind: str
    # Secret hygiene (reference: aggregator_core/src/lib.rs:28 SecretBytes
    # redacts Debug output): the token never reaches logs through repr.
    token: str = field(repr=False)

    def __post_init__(self):
        if self.kind == self.BEARER:
            # RFC 6750 §2.1 token68 charset, with optional trailing '='.
            stripped = self.token.rstrip("=")
            if not stripped or not all(_is_bearer_token_char(c) for c in stripped):
                raise ValueError("invalid bearer token")
        elif self.kind == self.DAP_AUTH:
            raw = self.token.encode()
            if not raw or len(raw) > _MAX_DAP_AUTH_TOKEN_LEN:
                raise ValueError("invalid DAP auth token length")
            if any(b == 0x25 or b < 0x21 or b > 0x7E for b in raw):
                raise ValueError("DAP auth token must be visible ASCII without %")
        else:
            raise ValueError(f"unknown token kind {self.kind}")

    @classmethod
    def new_bearer(cls, token: str) -> "AuthenticationToken":
        return cls(cls.BEARER, token)

    @classmethod
    def new_dap_auth(cls, token: str) -> "AuthenticationToken":
        return cls(cls.DAP_AUTH, token)

    @classmethod
    def random_bearer(cls) -> "AuthenticationToken":
        return cls.new_bearer(_b64url(os.urandom(16)))

    @classmethod
    def from_str(cls, s: str) -> "AuthenticationToken":
        """Parse "bearer:value" / "dap:value" flag syntax
        (reference: core/src/auth_tokens.rs FromStr)."""
        if s.startswith("bearer:"):
            return cls.new_bearer(s[len("bearer:") :])
        if s.startswith("dap:"):
            return cls.new_dap_auth(s[len("dap:") :])
        raise ValueError("bad or missing prefix on authentication token value")

    def request_authentication(self) -> tuple:
        """(header, value) pair for outgoing requests."""
        if self.kind == self.BEARER:
            return (AUTHORIZATION_HEADER, f"Bearer {self.token}")
        return (DAP_AUTH_HEADER, self.token)

    def as_bytes(self) -> bytes:
        return self.token.encode()

    def hash(self) -> "AuthenticationTokenHash":
        return AuthenticationTokenHash(self.kind, hashlib.sha256(self.as_bytes()).digest())


@dataclass(frozen=True)
class AuthenticationTokenHash:
    """Stored digest validated in constant time
    (reference: core/src/auth_tokens.rs:335)."""

    kind: str
    digest: bytes

    def validate(self, presented: AuthenticationToken) -> bool:
        if presented.kind != self.kind:
            return False
        return hmac.compare_digest(
            hashlib.sha256(presented.as_bytes()).digest(), self.digest
        )

    def to_dict(self) -> dict:
        return {"type": self.kind, "hash": _b64url(self.digest)}

    @classmethod
    def from_dict(cls, d: dict) -> "AuthenticationTokenHash":
        return cls(d["type"], _unb64url(d["hash"]))


def extract_bearer_token(headers) -> "AuthenticationToken | None":
    """Pull a bearer or DAP auth token from a request-header mapping."""
    auth = headers.get(AUTHORIZATION_HEADER) or headers.get(AUTHORIZATION_HEADER.lower())
    if auth and auth.startswith("Bearer "):
        try:
            return AuthenticationToken.new_bearer(auth[len("Bearer ") :])
        except ValueError:
            return None
    dap = headers.get(DAP_AUTH_HEADER) or headers.get(DAP_AUTH_HEADER.lower())
    if dap:
        try:
            return AuthenticationToken.new_dap_auth(dap)
        except ValueError:
            return None
    return None
