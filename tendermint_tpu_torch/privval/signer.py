"""Remote signer over a socket (reference: privval/signer.py; Go
privval/signer_client.go, signer_listener_endpoint.go,
signer_server.go).

Deployment model matches the reference's dialer mode: the SIGNER
process (holding the key, wrapping a FilePV) dials the validator
node's listen endpoint, so the key machine needs no open ports. The
node side (`SignerClient`) accepts that connection and then issues
sign requests over it; it implements `types.PrivValidator` with
async sign methods the consensus state machine awaits.

Security (reference parity: socket-based signers require
SecretConnection): when both sides are given a connection identity key
(`conn_key`), the link runs the Station-to-Station handshake from
p2p/conn/secret_connection.py — authenticated ChaCha20-Poly1305 both
ways — and each side may pin the peer's expected identity address.
Additionally the client ALWAYS verifies returned signatures against
the signer's validator pubkey and checks the signed payload matches
what was requested (modulo the timestamp, which the signer may rewind
per double-sign protection) — so even a compromised link cannot make
the node gossip a vote it did not ask for.

Frames: 4-byte big-endian length + JSON object (plaintext mode) or the
SecretConnection message layer (authenticated mode). Requests carry
canonical proto payloads hex-encoded."""

from __future__ import annotations

import asyncio
import json
import logging

from ..types.proposal import Proposal
from ..types.vote import Vote
from .file_pv import FilePV, RemoteSignError

logger = logging.getLogger("privval.signer")

_MAX_FRAME = 1 << 20


async def _read_frame(reader) -> dict:
    hdr = await reader.readexactly(4)
    ln = int.from_bytes(hdr, "big")
    if ln > _MAX_FRAME:
        raise ValueError("signer frame too large")
    return json.loads(await reader.readexactly(ln))


def _write_frame(writer, obj: dict) -> None:
    raw = json.dumps(obj).encode()
    writer.write(len(raw).to_bytes(4, "big") + raw)


class _Link:
    """One signer link: plaintext (reader, writer) or SecretConnection."""

    def __init__(self, reader=None, writer=None, sc=None):
        self._reader = reader
        self._writer = writer
        self._sc = sc

    @classmethod
    async def establish(cls, reader, writer, conn_key,
                        expected_peer_addr: bytes | None) -> "_Link":
        if conn_key is None:
            if expected_peer_addr is not None:
                raise RemoteSignError(
                    "cannot pin a peer identity on a plaintext link"
                )
            return cls(reader, writer)
        from ..p2p.conn.secret_connection import make_secret_connection

        sc = await make_secret_connection(reader, writer, conn_key)
        if expected_peer_addr is not None and \
                sc.remote_pubkey.address() != expected_peer_addr:
            sc.close()
            raise RemoteSignError(
                f"signer link peer identity mismatch: "
                f"{sc.remote_pubkey.address().hex()}"
            )
        return cls(sc=sc)

    async def recv(self) -> dict:
        if self._sc is not None:
            return json.loads(await self._sc.read_msg())
        return await _read_frame(self._reader)

    async def send(self, obj: dict) -> None:
        if self._sc is not None:
            await self._sc.write_msg(json.dumps(obj).encode())
        else:
            _write_frame(self._writer, obj)
            await self._writer.drain()

    def close(self) -> None:
        if self._sc is not None:
            self._sc.close()
        elif self._writer is not None:
            self._writer.close()


class SignerServer:
    """Runs NEXT TO THE KEY: wraps a FilePV and answers sign requests
    arriving on its connection (reference: privval/signer_server.go).

    conn_key: identity for the SecretConnection handshake (None =
    plaintext, for unix-socket/test deployments only).
    expected_node_addr: pin of the validator node's link identity."""

    def __init__(self, pv: FilePV, chain_id: str, conn_key=None,
                 expected_node_addr: bytes | None = None):
        self.pv = pv
        self.chain_id = chain_id
        self.conn_key = conn_key
        self.expected_node_addr = expected_node_addr

    async def serve_connection(self, reader, writer) -> None:
        try:
            link = await _Link.establish(
                reader, writer, self.conn_key, self.expected_node_addr
            )
        except Exception:
            logger.exception("signer link handshake failed")
            writer.close()
            return
        try:
            while True:
                req = await link.recv()
                await link.send(self._handle(req))
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            link.close()

    def _handle(self, req: dict) -> dict:
        t = req.get("type")
        try:
            if t == "ping":
                return {"type": "pong"}
            if t == "pub_key":
                pk = self.pv.get_pub_key()
                return {"type": "pub_key", "pub_key": pk.bytes().hex()}
            if t == "sign_vote":
                if req.get("chain_id") != self.chain_id:
                    raise RemoteSignError("chain id mismatch")
                vote = Vote.from_bytes(bytes.fromhex(req["vote"]))
                self.pv.sign_vote(self.chain_id, vote)
                return {"type": "signed_vote",
                        "vote": vote.to_bytes().hex()}
            if t == "sign_proposal":
                if req.get("chain_id") != self.chain_id:
                    raise RemoteSignError("chain id mismatch")
                prop = Proposal.from_bytes(bytes.fromhex(req["proposal"]))
                self.pv.sign_proposal(self.chain_id, prop)
                return {"type": "signed_proposal",
                        "proposal": prop.to_bytes().hex()}
            raise RemoteSignError(f"unknown request {t!r}")
        except RemoteSignError as e:
            return {"type": "error", "error": str(e)}
        except Exception as e:  # malformed payloads must not kill the link
            logger.exception("signer request failed")
            return {"type": "error", "error": f"internal: {e}"}

    async def dial_and_serve(self, host: str, port: int,
                             retries: int | None = 10,
                             retry_delay: float = 0.5,
                             on_event=None) -> None:
        """Dialer mode: connect OUT to the validator node
        (reference: privval/socket_dialers.go). retries=None redials
        FOREVER with a bounded backoff — the sidecar deployment shape,
        where outliving node restarts and shrugging off wire garbage is
        the point. Any wire error is
        backed off, never a tight loop; `on_event(msg)` reports
        connects/drops to the caller (the CLI prints them)."""
        attempt = 0
        while retries is None or attempt < retries:
            attempt += 1
            try:
                reader, writer = await asyncio.open_connection(host, port)
                if on_event:
                    on_event("connected to validator")
                await self.serve_connection(reader, writer)
                if retries is not None:
                    return
                if on_event:
                    on_event("validator link closed; redialing")
            except ConnectionError:
                pass
            except Exception as e:  # garbage frames, handshake noise
                if on_event:
                    on_event(f"signer link error: {e!r}")
            await asyncio.sleep(min(retry_delay * attempt, 2.0)
                                if retries is not None else retry_delay)
        raise ConnectionError(f"signer could not reach {host}:{port}")


def serve_signer(pv: FilePV, chain_id: str, host: str = "127.0.0.1",
                 port: int = 0, conn_key=None,
                 expected_node_addr: bytes | None = None):
    """Listener-mode signer (for tests/tools): returns the asyncio
    server; the validator's SignerClient dials it."""
    server = SignerServer(pv, chain_id, conn_key, expected_node_addr)
    return asyncio.start_server(server.serve_connection, host, port)


class SignerClient:
    """Runs IN THE NODE: implements PrivValidator over the socket
    (reference: privval/signer_client.go:16). One in-flight request at
    a time (the consensus event loop is serialized anyway).

    conn_key: identity for the SecretConnection handshake (None =
    plaintext). expected_signer_addr: pin of the signer's link
    identity — with it set, nobody else can impersonate the signer
    even with network reach."""

    def __init__(self, chain_id: str, timeout: float = 5.0, conn_key=None,
                 expected_signer_addr: bytes | None = None):
        self.chain_id = chain_id
        self.timeout = timeout
        self.conn_key = conn_key
        self.expected_signer_addr = expected_signer_addr
        self._link: _Link | None = None
        self._lock = asyncio.Lock()
        self._pub_key = None
        self._conn_q: asyncio.Queue | None = None
        self._server = None

    # -- connection management --

    async def listen(self, host: str = "127.0.0.1", port: int = 0):
        """Listener mode: accept the signer process dialing us
        (reference: SignerListenerEndpoint). The listener stays open
        for the client's lifetime so a restarted/reconnecting signer
        is picked back up on the next sign call — a validator must
        not go permanently mute because one TCP link dropped."""
        self._conn_q: asyncio.Queue = asyncio.Queue(maxsize=2)

        def on_conn(reader, writer):
            try:
                self._conn_q.put_nowait((reader, writer))
            except asyncio.QueueFull:
                writer.close()

        server = await asyncio.start_server(on_conn, host, port)
        self._server = server
        return server.sockets[0].getsockname()[1]

    async def _adopt(self, reader, writer) -> None:
        """Establish a link on a fresh connection and verify the key
        behind it. On RE-connection the signer must present the SAME
        validator key — a different dialer cannot take over."""
        from ..crypto.ed25519 import Ed25519PubKey

        link = await asyncio.wait_for(
            _Link.establish(reader, writer, self.conn_key,
                            self.expected_signer_addr),
            self.timeout,
        )
        try:
            await link.send({"type": "pub_key"})
            resp = await asyncio.wait_for(link.recv(), self.timeout)
            if resp.get("type") == "error" or "pub_key" not in resp:
                raise RemoteSignError(
                    f"signer pub_key exchange failed: {resp!r:.200}")
            pk = Ed25519PubKey(bytes.fromhex(resp["pub_key"]))
        except RemoteSignError:
            link.close()
            raise
        except Exception as e:
            link.close()
            raise RemoteSignError(
                f"signer pub_key exchange failed: {e!r}")
        if self._pub_key is not None and pk.bytes() != self._pub_key.bytes():
            link.close()
            raise RemoteSignError(
                "reconnected signer presented a DIFFERENT validator key")
        self._pub_key = pk
        self._link = link

    async def wait_connected(self) -> None:
        reader, writer = await asyncio.wait_for(self._conn_q.get(),
                                                self.timeout)
        await self._adopt(reader, writer)

    async def connect(self, reader, writer) -> None:
        """Direct wiring (tests)."""
        await self._adopt(reader, writer)

    def close(self) -> None:
        self._drop_link()
        if self._server is not None:
            self._server.close()
            self._server = None

    def _drop_link(self) -> None:
        if self._link is not None:
            try:
                self._link.close()
            except Exception:
                pass
            self._link = None

    async def _call(self, req: dict) -> dict:
        async with self._lock:
            if self._link is None:
                # a reconnected signer may be waiting in the accept
                # queue (listener mode) — adopt it now
                if self._conn_q is None:
                    raise RemoteSignError("signer not connected")
                try:
                    reader, writer = self._conn_q.get_nowait()
                except asyncio.QueueEmpty:
                    raise RemoteSignError("signer not connected")
                await self._adopt(reader, writer)
            try:
                await self._link.send(req)
                resp = await asyncio.wait_for(self._link.recv(),
                                              self.timeout)
            except (ConnectionError, asyncio.IncompleteReadError,
                    asyncio.TimeoutError, OSError, EOFError) as e:
                # dead link: drop it so the next call adopts the
                # signer's redial instead of failing forever
                self._drop_link()
                raise RemoteSignError(f"signer link lost: {e!r}")
        if resp.get("type") == "error":
            raise RemoteSignError(resp.get("error", "unknown"))
        return resp

    async def ping(self) -> None:
        await self._call({"type": "ping"})

    # -- PrivValidator --

    def get_pub_key(self):
        if self._pub_key is None:
            raise RemoteSignError("signer pub key not yet fetched")
        return self._pub_key

    async def sign_vote(self, chain_id: str, vote) -> None:
        resp = await self._call({"type": "sign_vote",
                                 "chain_id": chain_id,
                                 "vote": vote.to_bytes().hex()})
        signed = Vote.from_bytes(bytes.fromhex(resp["vote"]))
        # The signer may only change timestamp+signature; and the
        # signature must verify against OUR validator key for the
        # returned sign bytes — a hostile link cannot substitute
        # another payload.
        if (signed.type, signed.height, signed.round, signed.block_id,
                signed.validator_address, signed.validator_index) != (
                vote.type, vote.height, vote.round, vote.block_id,
                vote.validator_address, vote.validator_index):
            raise RemoteSignError("signer returned a different vote")
        if not self._pub_key.verify_signature(
                signed.sign_bytes(chain_id), signed.signature):
            raise RemoteSignError("signer returned an invalid signature")
        vote.signature = signed.signature
        vote.timestamp = signed.timestamp

    async def sign_proposal(self, chain_id: str, proposal) -> None:
        resp = await self._call({"type": "sign_proposal",
                                 "chain_id": chain_id,
                                 "proposal": proposal.to_bytes().hex()})
        signed = Proposal.from_bytes(bytes.fromhex(resp["proposal"]))
        if (signed.height, signed.round, signed.pol_round,
                signed.block_id) != (
                proposal.height, proposal.round, proposal.pol_round,
                proposal.block_id):
            raise RemoteSignError("signer returned a different proposal")
        if not self._pub_key.verify_signature(
                signed.sign_bytes(chain_id), signed.signature):
            raise RemoteSignError("signer returned an invalid signature")
        proposal.signature = signed.signature
        proposal.timestamp = signed.timestamp
