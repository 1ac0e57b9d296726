"""ASCII armor (reference: tendermint_tpu/crypto/armor.py, copied; Go
crypto/armor/armor.go, which wraps
OpenPGP-style armor from golang.org/x/crypto/openpgp/armor).

Format:
    -----BEGIN <block type>-----
    Key: Value            (headers)
                          (blank line)
    <base64, 64-col wrapped>
    =<base64 CRC-24>      (OpenPGP radix-64 checksum, RFC 4880 §6.1)
    -----END <block type>-----
"""

from __future__ import annotations

import base64

_CRC24_INIT = 0xB704CE
_CRC24_POLY = 0x1864CFB


def _crc24(data: bytes) -> int:
    crc = _CRC24_INIT
    for b in data:
        crc ^= b << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= _CRC24_POLY
    return crc & 0xFFFFFF


def encode_armor(block_type: str, headers: dict[str, str],
                 data: bytes) -> str:
    lines = [f"-----BEGIN {block_type}-----"]
    for k, v in headers.items():
        lines.append(f"{k}: {v}")
    lines.append("")
    b64 = base64.b64encode(data).decode()
    for i in range(0, len(b64), 64):
        lines.append(b64[i: i + 64])
    crc = base64.b64encode(_crc24(data).to_bytes(3, "big")).decode()
    lines.append(f"={crc}")
    lines.append(f"-----END {block_type}-----")
    return "\n".join(lines) + "\n"


def decode_armor(armor_str: str) -> tuple[str, dict[str, str], bytes]:
    """-> (block type, headers, data); raises ValueError on corruption."""
    lines = [ln.rstrip("\r") for ln in armor_str.strip().split("\n")]
    if not lines or not lines[0].startswith("-----BEGIN ") or \
            not lines[0].endswith("-----"):
        raise ValueError("armor: missing BEGIN line")
    block_type = lines[0][len("-----BEGIN "):-len("-----")]
    end = f"-----END {block_type}-----"
    if lines[-1] != end:
        raise ValueError("armor: missing or mismatched END line")
    headers: dict[str, str] = {}
    i = 1
    while i < len(lines) - 1 and lines[i]:
        if ":" not in lines[i]:
            break  # no blank line before body; tolerate like openpgp
        k, _, v = lines[i].partition(":")
        headers[k.strip()] = v.strip()
        i += 1
    if i < len(lines) - 1 and not lines[i]:
        i += 1
    body: list[str] = []
    crc_line = None
    for ln in lines[i:-1]:
        if ln.startswith("="):
            crc_line = ln[1:]
        elif ln:
            body.append(ln)
    try:
        data = base64.b64decode("".join(body), validate=True)
    except Exception as e:
        raise ValueError(f"armor: bad base64: {e}") from e
    if crc_line is not None:
        want = base64.b64decode(crc_line)
        if _crc24(data).to_bytes(3, "big") != want:
            raise ValueError("armor: CRC-24 mismatch")
    return block_type, headers, data
