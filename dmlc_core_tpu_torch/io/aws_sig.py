"""AWS Signature Version 4 signing (pure stdlib).

The reference signs S3 requests with SigV2 HMAC-SHA1 over libcurl
(src/io/s3_filesys.cc:86-121); the rebuild uses SigV4 (required by all
post-2014 AWS regions and by GCS's S3-compatible XML API) implemented on
hashlib/hmac — no SDK, keeping the zero-dependency stance of the reference.

Counterpart of ``dmlc_core_tpu/io/aws_sig.py`` (a copy).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse
from typing import Dict, Optional, Tuple

__all__ = ["sign_request", "Credentials"]


class Credentials:
    def __init__(self, access_key: str, secret_key: str,
                 session_token: Optional[str] = None, region: str = "us-east-1"):
        self.access_key = access_key
        self.secret_key = secret_key
        self.session_token = session_token
        self.region = region


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _quote(s: str, safe: str = "-_.~") -> str:
    return urllib.parse.quote(s, safe=safe)


def sign_request(
    creds: Credentials,
    method: str,
    host: str,
    path: str,
    query: Dict[str, str],
    headers: Dict[str, str],
    payload_sha256: str,
    service: str = "s3",
    now: Optional[datetime.datetime] = None,
) -> Dict[str, str]:
    """Return headers with SigV4 Authorization added.

    ``payload_sha256`` is the hex sha256 of the body ("UNSIGNED-PAYLOAD" is
    also accepted by S3 for streaming).
    """
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")

    out = dict(headers)
    out["host"] = host
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_sha256
    if creds.session_token:
        out["x-amz-security-token"] = creds.session_token

    canon_uri = _quote(path, safe="/-_.~")
    canon_query = "&".join(
        f"{_quote(k)}={_quote(str(v))}" for k, v in sorted(query.items()))
    signed_names = sorted(k.lower() for k in out)
    canon_headers = "".join(
        f"{name}:{str(out[_orig(out, name)]).strip()}\n" for name in signed_names)
    signed_headers = ";".join(signed_names)
    canonical_request = "\n".join([
        method.upper(), canon_uri, canon_query, canon_headers, signed_headers,
        payload_sha256,
    ])
    scope = f"{datestamp}/{creds.region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest(),
    ])
    k = _hmac(b"AWS4" + creds.secret_key.encode(), datestamp)
    k = _hmac(k, creds.region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={creds.access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}")
    return out


def _orig(headers: Dict[str, str], lower_name: str) -> str:
    for k in headers:
        if k.lower() == lower_name:
            return k
    return lower_name
