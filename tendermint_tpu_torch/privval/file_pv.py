"""File-backed validator key with double-sign protection (reference:
privval/file_pv.py; Go privval/file.go).

Sign flow (Go signVote file.go:316 / signProposal :351):
1. CheckHRS against the persisted last-sign state — regression in
   height/round/step is refused outright.
2. Same HRS + identical sign-bytes → re-release the saved signature
   (idempotent retry after a crash between persist and send).
3. Same HRS + sign-bytes differing ONLY in timestamp → re-release the
   saved signature too (Go checkVotesOnlyDifferByTimestamp,
   file.go:413: a restarted node re-builds the vote with a new
   wall-clock).
4. Anything else at the same HRS is a double-sign attempt → refuse.
5. New HRS: persist (fsync) the new state WITH the signature BEFORE
   returning it.

The key and state files are the reference's, byte for byte, and both
loaders accept the Go reference's tmjson forms as the reference's do."""

from __future__ import annotations

import base64
import json
import os
from dataclasses import dataclass

from ..crypto import ed25519, ed25519_privkey_from_json
from ..libs import failpoints
from ..types.canonical import (
    extract_canonical_timestamp,
    strip_canonical_timestamp,
)

# step numbers (Go privval/file.go:40-44)
STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_VOTE_TYPE_TO_STEP = {1: STEP_PREVOTE, 2: STEP_PRECOMMIT}


class RemoteSignError(Exception):
    """Signing refused (double-sign protection or remote failure)."""


@dataclass
class LastSignState:
    height: int = 0
    round: int = 0
    step: int = 0
    signature: bytes = b""
    sign_bytes: bytes = b""

    def check_hrs(self, height: int, round_: int, step: int) -> bool:
        """Returns True if this exact HRS was already signed (caller
        must then compare sign-bytes); raises on regression (Go
        file.go:94 CheckHRS)."""
        if self.height > height:
            raise RemoteSignError(
                f"height regression: {self.height} > {height}")
        if self.height == height:
            if self.round > round_:
                raise RemoteSignError(
                    f"round regression at height {height}: "
                    f"{self.round} > {round_}")
            if self.round == round_:
                if self.step > step:
                    raise RemoteSignError(
                        f"step regression at {height}/{round_}: "
                        f"{self.step} > {step}")
                if self.step == step:
                    if not self.sign_bytes:
                        raise RemoteSignError("no sign bytes at same HRS")
                    return True
        return False


class FilePV:
    """Go privval/file.go:151 FilePV."""

    def __init__(self, priv_key, key_path: str | None,
                 state_path: str | None):
        self.priv_key = priv_key
        self.key_path = key_path
        self.state_path = state_path
        self.last_sign_state = LastSignState()
        if state_path and os.path.exists(state_path):
            self._load_state()

    # -- construction ----------------------------------------------------

    @classmethod
    def generate(cls, key_path: str | None = None,
                 state_path: str | None = None) -> "FilePV":
        pv = cls(ed25519.Ed25519PrivKey.generate(), key_path, state_path)
        if key_path:
            pv.save_key()
        return pv

    @classmethod
    def load(cls, key_path: str, state_path: str) -> "FilePV":
        with open(key_path) as f:
            d = json.load(f)
        return cls(ed25519_privkey_from_json(d["priv_key"], "privval"),
                   key_path, state_path)

    @classmethod
    def load_or_generate(cls, key_path: str, state_path: str) -> "FilePV":
        if os.path.exists(key_path):
            return cls.load(key_path, state_path)
        return cls.generate(key_path, state_path)

    def save_key(self) -> None:
        assert self.key_path
        os.makedirs(os.path.dirname(self.key_path) or ".", exist_ok=True)
        tmp = self.key_path + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump({
                "type": "ed25519",
                "priv_key": self.priv_key.bytes().hex(),
                "pub_key": self.priv_key.pub_key().bytes().hex(),
                "address": self.priv_key.pub_key().address().hex(),
            }, f, indent=2)
        os.replace(tmp, self.key_path)

    def _load_state(self) -> None:
        """The repo's format or the Go reference's tmjson (string
        height, base64 signature, 'signbytes' hex): the last-sign state
        migrates, so double-sign protection survives the switch."""
        with open(self.state_path) as f:
            d = json.load(f)

        def sig_bytes(raw: str) -> bytes:
            try:
                return bytes.fromhex(raw)
            except ValueError:
                return base64.b64decode(raw)

        self.last_sign_state = LastSignState(
            height=int(d["height"]), round=int(d["round"]),
            step=int(d["step"]),
            signature=sig_bytes(d.get("signature") or ""),
            sign_bytes=bytes.fromhex(
                d.get("sign_bytes") or d.get("signbytes") or ""),
        )

    def _save_state(self, lss: LastSignState | None = None) -> None:
        """Persist + fsync BEFORE the signature escapes — this ordering
        IS the double-sign protection (Go file.go saveSigned). tmp +
        fsync + rename + directory fsync: the rename itself must be
        durable, or a crash right after can resurrect the OLD state
        file while the new signature is already on the wire."""
        if not self.state_path:
            return
        lss = lss if lss is not None else self.last_sign_state
        # an error here models dying between signing and persistence:
        # the signature must then never escape (the caller installs and
        # releases only after this returns)
        failpoints.hit("privval.save")
        d = os.path.dirname(self.state_path) or "."
        os.makedirs(d, exist_ok=True)
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "height": lss.height, "round": lss.round, "step": lss.step,
                "signature": lss.signature.hex(),
                "sign_bytes": lss.sign_bytes.hex(),
            }, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.state_path)
        try:
            dfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # some filesystems refuse directory fsync; best effort

    # -- PrivValidator ---------------------------------------------------

    def get_pub_key(self):
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote) -> None:
        step = _VOTE_TYPE_TO_STEP.get(int(vote.type))
        if step is None:
            raise RemoteSignError(f"unknown vote type {vote.type}")
        sb = vote.sign_bytes(chain_id)
        sig, saved_ts = self._sign_checked(vote.height, vote.round, step,
                                           sb, ts_field=5)
        if saved_ts is not None:
            # the re-released signature covers the ORIGINAL timestamp
            # (Go file.go signVote: vote.Timestamp = timestamp)
            vote.timestamp = saved_ts
        vote.signature = sig

    def sign_proposal(self, chain_id: str, proposal) -> None:
        sb = proposal.sign_bytes(chain_id)
        sig, saved_ts = self._sign_checked(proposal.height, proposal.round,
                                           STEP_PROPOSE, sb, ts_field=6)
        if saved_ts is not None:
            proposal.timestamp = saved_ts
        proposal.signature = sig

    def _sign_checked(self, height: int, round_: int, step: int,
                      sign_bytes: bytes,
                      ts_field: int) -> tuple[bytes, int | None]:
        """Returns (signature, original_timestamp_ns | None); a non-None
        timestamp means the caller must rewind its message's timestamp
        to match what the released signature actually covers."""
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(height, round_, step)
        if same_hrs:
            if sign_bytes == lss.sign_bytes:
                return lss.signature, None
            if _only_differ_by_timestamp(lss.sign_bytes, sign_bytes,
                                         ts_field=ts_field):
                return lss.signature, extract_canonical_timestamp(
                    lss.sign_bytes, ts_field)
            raise RemoteSignError(
                f"conflicting data at {height}/{round_}/{step}: "
                "refusing to double-sign")
        sig = self.priv_key.sign(sign_bytes)
        new_lss = LastSignState(
            height=height, round=round_, step=step,
            signature=sig, sign_bytes=sign_bytes)
        # Durable BEFORE installed: if the persist raises (disk error,
        # injected privval.save fault) the in-memory state stays at the
        # old HRS too, so a later retry never re-releases a signature
        # the state file never recorded.
        self._save_state(new_lss)
        self.last_sign_state = new_lss
        return sig, None


def _only_differ_by_timestamp(saved: bytes, new: bytes, *,
                              ts_field: int) -> bool:
    """True when the two canonical sign-byte blobs are identical with
    their timestamp fields stripped (Go file.go:413
    checkVotesOnlyDifferByTimestamp)."""
    try:
        return (strip_canonical_timestamp(saved, ts_field) ==
                strip_canonical_timestamp(new, ts_field))
    except Exception:
        return False
