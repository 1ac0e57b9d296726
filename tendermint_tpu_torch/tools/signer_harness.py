"""Remote-signer conformance harness (reference:
tendermint_tpu/tools/signer_harness.py, the same suite and exit codes;
Go tools/tm-signer-harness/internal/test_harness.go).

Acts as the NODE side of the privval socket protocol: listens for a
remote signer to dial in, then runs the conformance suite —

  1. TestPublicKey    signer's key matches the expected one (from a
                      priv_validator_key.json or genesis doc)
  2. TestSignProposal signs a proposal; the signature verifies against
                      the advertised key over canonical sign bytes
  3. TestSignVote     prevote + precommit at increasing HRS, each
                      verifying; then a conflicting re-sign at the SAME
                      HRS with a different block MUST be refused
                      (double-sign protection — the harness's whole
                      point: a signer that resigns conflicting votes is
                      unsafe to deploy)

Exit codes mirror the reference: 0 ok; 1 setup/connect failure;
2 public-key mismatch; 3 proposal failure; 4 vote failure;
5 double-sign accepted.

The link is plaintext, as the reference harness's, unless
`--secret-connection` (`conn_key=` in run_harness): then the harness
takes a fresh ed25519 identity and runs the SecretConnection handshake
that `cmd signer` always runs, so it can test that sidecar as deployed.

Usage:
    python -m tendermint_tpu_torch.tools.signer_harness \
        --laddr 127.0.0.1:28859 --chain-id my-chain \
        [--expected-key <hex pubkey | path to priv_validator_key.json>]

then point the signer at it, e.g.:
    python -m tendermint_tpu_torch.cmd --home H signer \
        --connect tcp://127.0.0.1:28859 [--device cpu]

The privval wire is byte-compatible with the reference's, so this
harness tests the reference's signer as well, and the reference's
harness tests the port's.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

from ..privval.signer import RemoteSignError, SignerClient
from ..types.block import BlockID, PartSetHeader
from ..types.proposal import Proposal
from ..types.vote import Vote, VoteType


class HarnessFailure(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


def _load_expected_key(spec: str) -> bytes | None:
    if not spec:
        return None
    if os.path.exists(spec):
        d = json.load(open(spec))
        return bytes.fromhex(d["pub_key"])
    return bytes.fromhex(spec)


async def run_harness(laddr: str, chain_id: str,
                      expected_key: bytes | None = None,
                      timeout: float = 30.0, log=print,
                      conn_key=None) -> int:
    host, _, port = laddr.partition(":")
    client = SignerClient(chain_id, timeout=timeout, conn_key=conn_key)
    try:
        actual_port = await client.listen(host or "127.0.0.1",
                                          int(port or 0))
        log(f"harness listening on {host}:{actual_port}; waiting for "
            f"the signer to dial in...")
        await client.wait_connected()
    except Exception as e:
        raise HarnessFailure(1, f"signer never connected: {e!r}") from e

    try:
        # 1. TestPublicKey
        pub = client.get_pub_key()
        log(f"signer public key: {pub.bytes().hex()}")
        if expected_key is not None and pub.bytes() != expected_key:
            raise HarnessFailure(
                2, f"public key mismatch: signer has "
                   f"{pub.bytes().hex()}, expected {expected_key.hex()}")
        log("TestPublicKey: OK")

        now = time.time_ns()
        bid = BlockID(b"\xab" * 32, PartSetHeader(1, b"\xcd" * 32))

        # 2. TestSignProposal
        prop = Proposal(height=1, round=0, pol_round=-1, block_id=bid,
                        timestamp=now)
        await client.sign_proposal(chain_id, prop)
        if not pub.verify_signature(prop.sign_bytes(chain_id),
                                    prop.signature):
            raise HarnessFailure(3, "proposal signature does not verify")
        log("TestSignProposal: OK")

        # 3. TestSignVote — prevote then precommit, then double-sign.
        addr = pub.address()
        for vt, name in ((VoteType.PREVOTE, "prevote"),
                         (VoteType.PRECOMMIT, "precommit")):
            vote = Vote(type=vt, height=2, round=0, block_id=bid,
                        timestamp=now, validator_address=addr,
                        validator_index=0)
            await client.sign_vote(chain_id, vote)
            if not pub.verify_signature(vote.sign_bytes(chain_id),
                                        vote.signature):
                raise HarnessFailure(
                    4, f"{name} signature does not verify")
            log(f"TestSignVote({name}): OK")

        # conflicting precommit at the SAME h/r for a DIFFERENT block
        evil_bid = BlockID(b"\xee" * 32, PartSetHeader(1, b"\xcd" * 32))
        evil = Vote(type=VoteType.PRECOMMIT, height=2, round=0,
                    block_id=evil_bid, timestamp=now + 1,
                    validator_address=addr, validator_index=0)
        try:
            await client.sign_vote(chain_id, evil)
        except RemoteSignError:
            log("TestDoubleSignRefused: OK")
        else:
            raise HarnessFailure(
                5, "signer RE-SIGNED a conflicting precommit at the "
                   "same height/round — double-sign protection absent")
        log("all conformance tests passed")
        return 0
    finally:
        client.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tm-signer-harness",
                                description=__doc__)
    p.add_argument("--laddr", default="127.0.0.1:28859")
    p.add_argument("--chain-id", required=True)
    p.add_argument("--expected-key", default="",
                   help="hex pubkey or priv_validator_key.json path")
    p.add_argument("--timeout", type=float, default=30.0)
    p.add_argument("--secret-connection", action="store_true",
                   help="run the SecretConnection handshake (as `cmd "
                        "signer` does) with a fresh identity")
    args = p.parse_args(argv)
    conn_key = None
    if args.secret_connection:
        from ..crypto.ed25519 import Ed25519PrivKey

        conn_key = Ed25519PrivKey.generate()
    try:
        return asyncio.run(run_harness(
            args.laddr, args.chain_id,
            _load_expected_key(args.expected_key),
            timeout=args.timeout, conn_key=conn_key))
    except HarnessFailure as e:
        print(f"FAILED ({e.code}): {e}", file=sys.stderr)
        return e.code


if __name__ == "__main__":
    sys.exit(main())
