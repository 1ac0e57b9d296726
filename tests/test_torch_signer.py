"""The port's remote signer (privval/signer.py) held against the JAX
package's over real TCP, both links authenticated by SecretConnection:
a port SignerClient with a reference SignerServer and the reverse, in
the dialer mode a tmkms deployment uses (the server, next to the key,
dials the node's listener). The same requests give the same replies,
signatures and refusals (a double sign, a wrong chain id); a pinned
signer identity that does not match, and a reconnecting signer with
another validator key, are refused; a dropped link is re-adopted on
the next call."""

from __future__ import annotations

import asyncio
import hashlib
import importlib
import types

import pytest

CHAIN = "signer-chain"
DEADLINE_S = 60.0


def _namespace(root: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(name=root)
    for mod in ("privval", "privval.signer", "crypto.ed25519", "types.block",
                "types.proposal", "types.vote"):
        setattr(ns, mod.rsplit(".", 1)[-1],
                importlib.import_module(f"{root}.{mod}"))
    return ns


PORT = _namespace("tendermint_tpu_torch")
REF = _namespace("tendermint_tpu")
PAIRS = [(PORT, REF), (REF, PORT), (PORT, PORT)]
PAIR_IDS = ["port-client-ref-server", "ref-client-port-server", "port-port"]


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


def key(p, i: int):
    return p.ed25519.Ed25519PrivKey(hashlib.sha256(b"signer-%d" % i).digest())


def bid(p, s: int):
    return p.block.BlockID(bytes([s]) * 32,
                           p.block.PartSetHeader(1, bytes([s]) * 32))


def vote(p, height, round_, s=1, ts=1000):
    return p.vote.Vote(type=p.vote.VoteType.PREVOTE, height=height,
                       round=round_, block_id=bid(p, s), timestamp=ts,
                       validator_address=b"\x01" * 20, validator_index=0)


async def start_pair(pc, ps, tmp_path, server_key=0, pin=None):
    """A listening client and a server dialing it; returns both and the
    server's task once the client adopted the link."""
    pv = ps.privval.FilePV(key(ps, server_key), None,
                           str(tmp_path / f"{ps.name}-state.json"))
    client = pc.privval.SignerClient(CHAIN, conn_key=key(pc, 10),
                                     expected_signer_addr=pin)
    port = await client.listen()
    server = ps.privval.SignerServer(pv, CHAIN, conn_key=key(ps, 11))
    task = asyncio.get_running_loop().create_task(
        server.dial_and_serve("127.0.0.1", port, retries=None,
                              retry_delay=0.05))
    return pv, client, task


async def outcome(coro):
    try:
        await coro
        return "ok"
    except Exception as e:
        return f"{type(e).__name__}: {e}"


async def flow(pc, ps, d):
    """ping, a vote, a double sign, a wrong chain id, a proposal."""
    d.mkdir(exist_ok=True)
    pv, client, task = await start_pair(pc, ps, d)
    await client.wait_connected()
    out = [client.get_pub_key().bytes().hex(), await outcome(client.ping())]
    v = vote(pc, 1, 0)
    out.append(await outcome(client.sign_vote(CHAIN, v)))
    out.append((v.signature.hex(), v.timestamp))
    out.append(await outcome(client.sign_vote(CHAIN, vote(pc, 1, 0, 9))))
    out.append(await outcome(client.sign_vote("other-chain",
                                              vote(pc, 2, 0))))
    prop = pc.proposal.Proposal(height=2, round=0, pol_round=-1,
                                block_id=bid(pc, 3), timestamp=5)
    out.append(await outcome(client.sign_proposal(CHAIN, prop)))
    out.append(prop.signature.hex())
    lss = pv.last_sign_state
    out.append((lss.height, lss.round, lss.step))
    client.close()
    task.cancel()
    return out


@pytest.mark.parametrize("pc,ps", PAIRS, ids=PAIR_IDS)
def test_sign_requests_across_packages(pc, ps, tmp_path):
    got = run(flow(pc, ps, tmp_path / "pair"))
    assert got[1:3] == ["ok", "ok"] and got[6] == "ok"
    assert got[4].startswith("RemoteSignError: ") and \
        "double-sign" in got[4]
    assert got[5] == "RemoteSignError: chain id mismatch"
    assert got[8] == (2, 0, 1)
    # replies, signatures and refusals equal the reference pair's
    assert got == run(flow(REF, REF, tmp_path / "ref"))


@pytest.mark.parametrize("pc,ps", PAIRS[:2], ids=PAIR_IDS[:2])
def test_a_wrong_signer_identity_is_refused(pc, ps, tmp_path):
    """A client pinned to another link identity refuses the signer at
    the handshake."""
    async def go():
        wrong = key(pc, 99).pub_key().address()
        _, client, task = await start_pair(pc, ps, tmp_path, pin=wrong)
        got = await outcome(client.wait_connected())
        client.close()
        task.cancel()
        return got

    got = run(go())
    assert got.startswith("RemoteSignError: signer link peer identity "
                          "mismatch")


def test_a_dropped_link_is_readopted_and_another_key_refused(tmp_path):
    """The port client drops a dead link, the server redials, the next
    call adopts it and signs on; a signer with another validator key
    that dials in later is refused."""
    async def go():
        pv, client, task = await start_pair(PORT, PORT, tmp_path)
        await client.wait_connected()
        await client.sign_vote(CHAIN, vote(PORT, 1, 0))
        client._link.close()  # the link drops under the node
        lost = await outcome(client.sign_vote(CHAIN, vote(PORT, 2, 0)))
        for _ in range(200):
            if not client._conn_q.empty():
                break
            await asyncio.sleep(0.01)
        again = await outcome(client.sign_vote(CHAIN, vote(PORT, 3, 0)))
        lss = pv.last_sign_state
        state = (lss.height, lss.round, lss.step)
        task.cancel()
        # another key dials in: the next adoption refuses it
        client._drop_link()
        other = PORT.privval.SignerServer(
            PORT.privval.FilePV(key(PORT, 5), None, None), CHAIN,
            conn_key=key(PORT, 12))
        port = client._server.sockets[0].getsockname()[1]
        t2 = asyncio.get_running_loop().create_task(
            other.dial_and_serve("127.0.0.1", port, retries=None,
                                 retry_delay=0.05))
        for _ in range(200):
            if not client._conn_q.empty():
                break
            await asyncio.sleep(0.01)
        refused = await outcome(client.sign_vote(CHAIN, vote(PORT, 4, 0)))
        client.close()
        t2.cancel()
        return lost, again, state, refused

    lost, again, state, refused = run(go())
    assert lost.startswith("RemoteSignError: signer link lost")
    assert again == "ok" and state == (3, 0, 2)
    assert refused == ("RemoteSignError: reconnected signer presented a "
                       "DIFFERENT validator key")
