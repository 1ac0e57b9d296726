"""Structured sign-bytes: template + per-lane timestamp patch.

Within one commit — and across the votes of one (type, height, round,
block_id) — every canonical sign-byte blob shares all content except
the timestamp field and the outer length prefix (types/canonical.py
vote_sign_bytes; reference types/canonical.go). Shipping full
(N, ~190 B) sign-byte rows to the device per verify is therefore
~90% redundant — the dominant host->device transfer term — and
building them costs one Python protobuf Writer per lane.

The structured batches here capture the structure instead:

  sign_bytes[lane] = outer_varint ‖ pre[group] ‖ ts_field ‖ suf[group]

with a handful of (pre, suf) template groups and a <=20-byte per-lane
patch = outer_varint ‖ ts_field built by vectorized numpy (no per-lane
Python). The assembly kernel (crypto/cuda/expanded.py, `assemble`)
reassembles the exact bytes on device; `materialize()` yields the
identical full bytes for host/fallback paths, and tests enforce byte
equality between the two.

This slice of the port carries CommitSignBatch — one commit's slots
(groups: for-block vs nil). The fast-sync and vote micro-batch shapes
come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import canonical

PATCH_W = 24  # outer varint (<=2) + ts field (<=18), zero-padded

# Template groups the assembly kernel accepts per launch
# (crypto/cuda/expanded.py pads to exactly this many rows). Builders
# raise ValueError past it so call sites fall back to full bytes
# SILENTLY — overflow is an input property (e.g. a peer fabricating
# many distinct block_ids in one gossip burst), not a template bug.
MAX_GROUPS = 32


def _vlen(v: np.ndarray) -> np.ndarray:
    """Minimal varint byte length per element (v > 0)."""
    bits = np.zeros(v.shape, np.int64)
    x = v.astype(np.int64)
    for shift in (32, 16, 8, 4, 2, 1):
        hi = x >= (1 << shift)
        bits += np.where(hi, shift, 0)
        x = np.where(hi, x >> shift, x)
    return (bits // 7 + 1).astype(np.int64)


def _varint_digits(out: np.ndarray, col: int, v: np.ndarray, ln: int):
    """Write the ln-byte minimal varint of each v into out[:, col:]."""
    for j in range(ln):
        b = (v >> (7 * j)) & 0x7F
        if j < ln - 1:
            b = b | 0x80
        out[:, col + j] = b
    return col + ln


def _pack_templates(parts: list[tuple[bytes, bytes]]):
    """(pre, suf) template list -> padded arrays + lengths."""
    k = max(len(parts), 1)
    if not parts:
        parts = [(b"", b"")]
    pw = max(max(len(p) for p, _ in parts), 1)
    sw = max(max(len(s) for _, s in parts), 1)
    pre = np.zeros((k, pw), np.uint8)
    suf = np.zeros((k, sw), np.uint8)
    pre_len = np.zeros(k, np.int32)
    suf_len = np.zeros(k, np.int32)
    for g, (p, s) in enumerate(parts):
        pre[g, :len(p)] = np.frombuffer(p, np.uint8)
        suf[g, :len(s)] = np.frombuffer(s, np.uint8)
        pre_len[g] = len(p)
        suf_len[g] = len(s)
    return pre, pre_len, suf, suf_len


def _build_patches(pre_len, suf_len, group, ts):
    """Vectorized outer-varint + ts-field assembly, grouped by byte
    layout (within one batch there are only a handful: seconds share
    a varint width, nanos vary 1-5 bytes).

    Returns (patch, split, patch_len); raises ValueError when a blob
    would exceed the two-byte outer-varint range."""
    n = ts.shape[0]
    secs = ts // 1_000_000_000
    nanos = ts % 1_000_000_000
    ls = np.where(secs > 0, _vlen(np.maximum(secs, 1)), 0)
    ln = np.where(nanos > 0, _vlen(np.maximum(nanos, 1)), 0)
    pay = np.where(secs > 0, 1 + ls, 0) + np.where(nanos > 0, 1 + ln, 0)
    tsf_total = np.where(ts > 0, 2 + pay, 0)
    body = (pre_len[group].astype(np.int64) + tsf_total
            + suf_len[group])
    if body.size and body.max() >= 1 << 14:
        raise ValueError("sign bytes too long for structured batch")
    outer_len = np.where(body >= 128, 2, 1)

    patch = np.zeros((n, PATCH_W), np.uint8)
    split = outer_len.astype(np.int32)
    patch_len = (outer_len + tsf_total).astype(np.int32)
    # layout key: everything that fixes byte positions/constants
    key = (group.astype(np.int64) * 4 + (secs > 0) * 2
           + (nanos > 0)) * 1024 + ls * 64 + ln * 8 + outer_len
    for kv in np.unique(key):
        m = key == kv
        ol = int(outer_len[m][0])
        bd = int(body[m][0])
        if ol == 1:
            patch[m, 0] = bd
        else:
            patch[m, 0] = (bd & 0x7F) | 0x80
            patch[m, 1] = bd >> 7
        if int(tsf_total[m][0]) == 0:
            continue
        sub = np.zeros((int(m.sum()), PATCH_W - ol), np.uint8)
        sub[:, 0] = 0x2A  # field 5, wire type 2
        sub[:, 1] = pay[m]
        col = 2
        if int((secs > 0)[m][0]):
            sub[:, col] = 0x08
            col = _varint_digits(sub, col + 1, secs[m], int(ls[m][0]))
        if int((nanos > 0)[m][0]):
            sub[:, col] = 0x10
            col = _varint_digits(sub, col + 1, nanos[m], int(ln[m][0]))
        patch[m, ol:] = sub
    return patch, split, patch_len


def _check_ts(ts: int) -> int:
    if not 0 <= ts < 1 << 63:
        # Vectorized path is int64; a (hostile) timestamp past year
        # 2262 falls back to the full-bytes path instead.
        raise ValueError("timestamp out of int64 range")
    return ts


class StructuredSignBytes:
    """Base for structured sign-byte batches: the field layout the
    device kernel front-end consumes (pre/suf templates + per-lane
    group/patch/split/patch_len) plus the host-side reassembly the
    self-check and width selection need. ValidatorSet's batch verify
    dispatches on this type."""

    def _finish(self, parts, group, ts):
        self.pre, self.pre_len, self.suf, self.suf_len = \
            _pack_templates(parts)
        self.group = group
        self.patch, self.split, self.patch_len = _build_patches(
            self.pre_len, self.suf_len, group, ts)

    def host_assemble(self, i: int) -> bytes:
        """Reassemble lane i's sign bytes host-side with the SAME
        boundary math the device kernel uses — the runtime self-check
        anchor (compared against anchor_bytes()/materialize())."""
        g = int(self.group[i])
        a = int(self.split[i])
        pl = int(self.patch_len[i])
        return (bytes(self.patch[i, :a])
                + bytes(self.pre[g, :self.pre_len[g]])
                + bytes(self.patch[i, a:pl])
                + bytes(self.suf[g, :self.suf_len[g]]))

    def anchor_bytes(self) -> bytes:
        """Lane 0's canonical sign bytes, computed INDEPENDENTLY of
        the structured arrays — the runtime self-check compares
        host_assemble(0) against this before any launch."""
        raise NotImplementedError

    def msg_lens(self) -> np.ndarray:
        """Per-lane total sign-byte length (outer prefix included)."""
        return (self.patch_len + self.pre_len[self.group]
                + self.suf_len[self.group]).astype(np.int64)

    def max_msg_len(self) -> int:
        return int(self.msg_lens().max()) if len(self) else 0


@dataclass
class CommitSignBatch(StructuredSignBytes):
    """Sign bytes for a list of commit slots, in structured form."""

    chain_id: str
    commit: object
    slots: list[int]
    # templates, one row per group
    pre: np.ndarray = field(init=False)       # (K, PW) uint8
    pre_len: np.ndarray = field(init=False)   # (K,) int32
    suf: np.ndarray = field(init=False)       # (K, SW) uint8
    suf_len: np.ndarray = field(init=False)   # (K,) int32
    # per-lane
    group: np.ndarray = field(init=False)     # (N,) int32
    patch: np.ndarray = field(init=False)     # (N, PATCH_W) uint8
    split: np.ndarray = field(init=False)     # (N,) int32 outer-varint len
    patch_len: np.ndarray = field(init=False)  # (N,) int32

    def __post_init__(self):
        from .vote import VoteType

        commit, chain_id = self.commit, self.chain_id
        n = len(self.slots)
        parts: list[tuple[bytes, bytes]] = []   # group id -> (pre, suf)
        group_of: dict[bool, int] = {}          # keyed by for_block()
        group = np.zeros(n, np.int32)
        ts = np.zeros(n, np.int64)
        for i, slot in enumerate(self.slots):
            cs = commit.signatures[slot]
            ts[i] = _check_ts(cs.timestamp)
            fb = cs.for_block()
            g = group_of.get(fb)
            if g is None:
                g = len(parts)
                group_of[fb] = g
                parts.append(canonical.vote_sign_parts(
                    chain_id, int(VoteType.PRECOMMIT), commit.height,
                    commit.round, cs.block_id_for(commit.block_id)))
            group[i] = g
        self._finish(parts, group, ts)

    def __len__(self) -> int:
        return len(self.slots)

    def anchor_bytes(self) -> bytes:
        return self.commit.vote_sign_bytes(self.chain_id, self.slots[0])

    def materialize(self) -> list[bytes]:
        """Full canonical sign bytes per lane (host/fallback path)."""
        return [self.commit.vote_sign_bytes(self.chain_id, s)
                for s in self.slots]
