"""Light proxy: a JSON-RPC server whose block-bearing responses are
LIGHT-VERIFIED before they leave the process (reference:
light/proxy.py; Go light/proxy/proxy.go:16, light/proxy/routes.go).

A wallet or indexer points at this proxy exactly as it would at a full
node; the proxy forwards transaction submission and queries to the
primary, but every header/commit/validator-set it returns has passed
the light client's verification (sequential or skipping + witness
cross-check), and every full block fetched from the primary is checked
against the corresponding verified header hash. A lying primary
cannot feed this proxy's clients a forged chain — the request fails
instead.

The port's fault rule (crypto/batch.py UNCAUGHT): a ``KernelError`` or
``NoDeviceError`` under a verification ends that request with an
internal error, becomes the proxy's ``fault`` and goes to its owner's
``on_fault``. It is never served as "unverified" or "not found".
"""

from __future__ import annotations

import logging

from ..rpc.jsonrpc import JSONRPCServer, RPCError
from .client import Client
from .errors import LightClientError
from .provider import BlockNotFoundError
from .serving import LightServingShedError

logger = logging.getLogger("light.proxy")


class LightProxy:
    """Serves verified RPC routes from a light `Client`.

    forward_client: an ``HTTPClient`` to the primary's RPC, used for
    pass-through routes (tx broadcast, abci queries, full blocks);
    None disables those routes (verified-only mode, e.g. tests over a
    BlockStoreProvider primary).
    """

    def __init__(self, client: Client, forward_client=None,
                 proof_runtime=None, plane=None, on_fault=None):
        self.client = client
        self.fault: BaseException | None = None
        self._on_fault = on_fault
        self.forward = forward_client
        # Shared verification plane (light/serving.py ServingPlane):
        # when set, every verified route resolves heights through it —
        # request coalescing, the verified-header cache and batched
        # commit verification — instead of walking the client
        # serially. Several proxy workers (ServingPool) share one.
        self.plane = plane
        # app-defined proof formats decode through this registry
        # (reference: lrpc.KeyPathFn/prt options); default knows the
        # kvstore ops, apps with their own formats inject a runtime
        self._prt = proof_runtime
        self.server = JSONRPCServer(self._routes(),
                                    ws_routes=self._ws_routes(),
                                    on_fault=self._fault)
        self.server._on_ws_close = self._on_ws_close
        self.port: int | None = None

    def _fault(self, exc: BaseException) -> None:
        """A port fault met under a request: keep it, tell the owner."""
        if self.fault is None:
            self.fault = exc
        if self._on_fault is not None:
            self._on_fault(exc)

    async def listen(self, host: str, port: int) -> int:
        self.port = await self.server.listen(host, port)
        logger.info("light proxy serving verified RPC on %s:%d",
                    host, self.port)
        return self.port

    def close(self) -> None:
        self.server.close()

    def _routes(self) -> dict:
        routes = {
            "status": self.status,
            "commit": self.commit,
            "validators": self.validators,
            "block": self.block,
            "header": self.header,
            "health": self.health,
        }
        if self.forward is not None:
            # verified pass-throughs (reference light/rpc/client.go):
            # the answer is checked against light-verified state
            routes["abci_query"] = self.abci_query
            routes["block_by_hash"] = self.block_by_hash
            routes["block_results"] = self.block_results
            routes["tx"] = self.tx
            routes["blockchain"] = self.blockchain
            routes["consensus_params"] = self.consensus_params
            # plain pass-throughs — the set the reference also relays
            # without light verification (lrpc client delegates these
            # straight to `next`)
            for name in ("broadcast_tx_sync", "broadcast_tx_async",
                         "broadcast_tx_commit", "abci_info",
                         "tx_search", "net_info",
                         "genesis", "genesis_chunked", "block_search",
                         "consensus_state", "dump_consensus_state",
                         "unconfirmed_txs",
                         "num_unconfirmed_txs", "check_tx",
                         "broadcast_evidence"):
                routes[name] = self._forwarder(name)
        return routes

    # -- verified routes --

    async def _verified_block_at(self, height) -> "object":
        from ..rpc.jsonrpc import CODE_BUSY

        h = int(height) if height else 0
        try:
            if self.plane is not None:
                lb = await self.plane.get_verified(h)
            elif h == 0:
                lb = await self.client.update()
                if lb is None:
                    lb = self.client.trusted_light_block()
            else:
                lb = await self.client.verify_light_block_at_height(h)
        except LightServingShedError as e:
            # backpressure, not a verdict: same 429 vocabulary as the
            # RPC overload limiter and the mempool admission sheds
            raise RPCError(CODE_BUSY, str(e), "queue_full")
        except (LightClientError, BlockNotFoundError) as e:
            raise RPCError(-32603, f"light verification failed: {e}")
        if lb is None:
            raise RPCError(-32603, "no trusted block yet")
        return lb

    async def health(self, ctx) -> dict:
        return {}

    async def status(self, ctx) -> dict:
        lb = self.client.trusted_light_block()
        if lb is None:
            raise RPCError(-32603, "light client not initialized")
        h = lb.signed_header.header
        return {
            "node_info": {
                "network": h.chain_id,
                "moniker": "light-proxy",
                "version": "tendermint-tpu/light",
            },
            "sync_info": {
                "latest_block_height": str(h.height),
                "latest_block_hash": lb.hash().hex().upper(),
                "latest_app_hash": h.app_hash.hex().upper(),
                "latest_block_time": str(h.time),
                "catching_up": False,
            },
        }

    async def commit(self, ctx, height=None) -> dict:
        from ..rpc.core import _commit_json, _header_json

        lb = await self._verified_block_at(height)
        return {
            "signed_header": {
                "header": _header_json(lb.signed_header.header),
                "commit": _commit_json(lb.signed_header.commit),
            },
            "canonical": True,
        }

    async def header(self, ctx, height=None) -> dict:
        from ..rpc.core import _header_json

        lb = await self._verified_block_at(height)
        return {"header": _header_json(lb.signed_header.header)}

    async def validators(self, ctx, height=None, page=1,
                         per_page=30) -> dict:
        from ..rpc.core import _validator_json

        lb = await self._verified_block_at(height)
        vals = lb.validator_set
        page, per_page = max(int(page), 1), min(max(int(per_page), 1), 100)
        start = (page - 1) * per_page
        sel = vals.validators[start:start + per_page]
        return {"block_height": str(lb.height()),
                "validators": [_validator_json(v) for v in sel],
                "count": str(len(sel)), "total": str(len(vals))}

    async def block(self, ctx, height=None) -> dict:
        """Full block from the primary, checked hash-for-hash against
        the light-verified header (reference routes.go BlockFn →
        proxy verification)."""
        if self.forward is None:
            raise RPCError(-32601, "block pass-through not configured")
        lb = await self._verified_block_at(height)
        res = await self.forward.call("block", height=lb.height())
        got = bytes.fromhex(res["block_id"]["hash"])
        want = lb.hash()
        if got != want:
            raise RPCError(
                -32603,
                f"primary served block {got.hex()[:16]}… but the "
                f"verified header at height {lb.height()} is "
                f"{want.hex()[:16]}… — refusing to relay a forged block")
        # and the BODY must actually hash to that id (a forged body
        # under a truthful block_id must not pass)
        self._check_block_body(res, want)
        return res

    def _check_block_body(self, res: dict, want: bytes) -> None:
        """The served BODY must hash to `want`: recompute the header
        hash from the response (not the primary's claimed block_id)
        and bind the tx payload to header.data_hash — a primary
        cannot attach a forged body under a real verified hash
        (reference client.go BlockByHash res.Block.ValidateBasic +
        Hash comparison)."""
        import base64

        from ..crypto import merkle
        from ..rpc.core import header_from_json

        hdr = header_from_json(res["block"]["header"])
        if hdr.hash() != want:
            raise RPCError(
                -32603,
                f"served block body hashes to {hdr.hash().hex()[:16]}… "
                f"not the verified {want.hex()[:16]}…")
        txs = [base64.b64decode(t)
               for t in res["block"]["data"].get("txs") or []]
        if merkle.hash_from_byte_slices(txs) != hdr.data_hash:
            raise RPCError(
                -32603, "served txs do not match the header's data_hash")

    async def block_by_hash(self, ctx, hash="") -> dict:
        """reference light/rpc/client.go:314 BlockByHash: the answer
        must be the block WE asked for (requested hash), its body must
        hash to that id, and the id must equal the light-verified
        header at that height."""
        if self.forward is None:
            raise RPCError(-32601, "pass-through not configured")
        from ..rpc.core import coerce_hex_param

        hash = coerce_hex_param(hash)
        want = bytes.fromhex(hash)
        res = await self.forward.call("block_by_hash", hash=hash)
        h = int(res["block"]["header"]["height"])
        self._check_block_body(res, want)
        # the relayed block_id must be the verified id too — clients
        # record it as the canonical hash
        if bytes.fromhex(res["block_id"]["hash"]) != want:
            raise RPCError(
                -32603, "block_id does not match the requested hash")
        lb = await self._verified_block_at(h)
        if want != lb.hash():
            raise RPCError(
                -32603,
                f"block {want.hex()[:16]}… at height {h} does not "
                f"match the verified header {lb.hash().hex()[:16]}…")
        return res

    async def block_results(self, ctx, height=None) -> dict:
        """reference light/rpc/client.go:349 BlockResults: recompute
        the deliver-tx results hash from the response and check it
        against header(h+1).last_results_hash — tampered tx results
        (codes/data) are rejected."""
        import base64
        from types import SimpleNamespace

        if self.forward is None:
            raise RPCError(-32601, "pass-through not configured")
        if height in (None, 0, "0", ""):
            # latest results aren't provable yet (their hash lands in
            # the NEXT header) — serve the previous block's instead,
            # as the reference does (client.go:352-358)
            st = await self.forward.call("status")
            height = int(st["sync_info"]["latest_block_height"]) - 1
        res = await self.forward.call("block_results", height=height)
        h = int(height)
        if h <= 0:
            raise RPCError(-32603, "zero or negative results height")
        if int(res.get("height") or 0) != h:
            # verification is against the REQUESTED height; an answer
            # for some other height must not slip through
            raise RPCError(
                -32603,
                f"primary answered for height {res.get('height')} but "
                f"{h} was requested")
        lb = await self._verified_block_at(h + 1)
        from ..state import abci_results_hash

        rs = [SimpleNamespace(
            code=int(t.get("code", 0)),
            data=base64.b64decode(t.get("data") or ""))
            for t in res.get("txs_results") or []]
        want = lb.signed_header.header.last_results_hash
        if abci_results_hash(rs) != want:
            raise RPCError(
                -32603,
                f"results hash mismatch for height {h} — refusing to "
                "relay tampered block results")
        return res

    async def tx(self, ctx, hash="", prove=True) -> dict:
        """reference light/rpc/client.go:425 Tx: prove is forced on
        and the tx merkle proof is validated against the verified
        header's data_hash."""
        import base64

        if self.forward is None:
            raise RPCError(-32601, "pass-through not configured")
        from ..crypto import tmhash
        from ..rpc.core import coerce_hex_param

        hash = coerce_hex_param(hash)
        res = await self.forward.call("tx", hash=hash, prove=True)
        h = int(res["height"])
        if h <= 0:
            raise RPCError(-32603, "zero or negative tx height")
        proof = res.get("proof")
        if not proof:
            raise RPCError(-32603, "no proof in tx response")
        txb = base64.b64decode(res.get("tx") or "")
        # the proven tx must BE the one we asked for — an honest
        # inclusion proof for a different committed tx must not pass
        if tmhash.sum256(txb) != bytes.fromhex(hash):
            raise RPCError(
                -32603,
                f"primary answered with a tx hashing to "
                f"{tmhash.sum256(txb).hex()[:16]}… but {hash[:16]}… "
                "was queried")
        lb = await self._verified_block_at(h)
        from ..crypto import merkle

        pj = proof["proof"]
        p = merkle.Proof(
            total=int(pj["total"]), index=int(pj["index"]),
            leaf_hash=base64.b64decode(pj["leaf_hash"]),
            aunts=[base64.b64decode(a) for a in pj.get("aunts", [])])
        if not p.verify(lb.signed_header.header.data_hash, txb):
            raise RPCError(
                -32603,
                f"tx proof failed against data_hash of verified "
                f"header {h} — refusing to relay")
        return res

    async def blockchain(self, ctx, min_height=None,
                         max_height=None) -> dict:
        """reference lrpc client BlockchainInfo: every returned
        BlockMeta's header must recompute to its claimed block id and
        match the light-verified header at that height."""
        if self.forward is None:
            raise RPCError(-32601, "pass-through not configured")
        from ..rpc.core import header_from_json

        res = await self.forward.call(
            "blockchain", min_height=min_height, max_height=max_height)
        lo = int(min_height) if min_height not in (None, "", "0", 0) \
            else None
        hi = int(max_height) if max_height not in (None, "", "0", 0) \
            else None
        for meta in res.get("block_metas") or []:
            hdr = header_from_json(meta["header"])
            # answers must stay inside the requested range — a
            # different (individually valid) range must not pass
            if (lo is not None and hdr.height < lo) or \
                    (hi is not None and hdr.height > hi):
                raise RPCError(
                    -32603,
                    f"block meta height {hdr.height} outside the "
                    f"requested range [{min_height}, {max_height}]")
            want = bytes.fromhex(meta["block_id"]["hash"])
            if hdr.hash() != want:
                raise RPCError(
                    -32603,
                    f"block meta at height {hdr.height}: header does "
                    "not hash to its claimed block id")
            lb = await self._verified_block_at(hdr.height)
            if lb.hash() != want:
                raise RPCError(
                    -32603,
                    f"block meta at height {hdr.height} does not match "
                    "the verified header")
        return res

    async def consensus_params(self, ctx, height=None) -> dict:
        """reference lrpc client ConsensusParams: the returned params
        must hash to the verified header's consensus_hash."""
        if self.forward is None:
            raise RPCError(-32601, "pass-through not configured")
        from ..types.params import (BlockParams, ConsensusParams,
                                    EvidenceParams, ValidatorParams,
                                    VersionParams)

        res = await self.forward.call("consensus_params", height=height)
        h = int(res["block_height"])
        if height not in (None, 0, "0", "") and h != int(height):
            raise RPCError(
                -32603,
                f"primary answered params for height {h} but "
                f"{height} was requested")
        cp = res["consensus_params"]
        params = ConsensusParams(
            block=BlockParams(
                max_bytes=int(cp["block"]["max_bytes"]),
                max_gas=int(cp["block"]["max_gas"])),
            evidence=EvidenceParams(
                max_age_num_blocks=int(
                    cp["evidence"]["max_age_num_blocks"]),
                max_age_duration_ns=int(
                    cp["evidence"]["max_age_duration"]),
                max_bytes=int(cp["evidence"]["max_bytes"])),
            validator=ValidatorParams(
                pub_key_types=list(cp["validator"]["pub_key_types"])),
            version=VersionParams(app_version=int(
                (cp.get("version") or {}).get("app_version", 0))),
        )
        lb = await self._verified_block_at(h)
        if params.hash() != lb.signed_header.header.consensus_hash:
            raise RPCError(
                -32603,
                f"consensus params do not hash to the verified "
                f"header {h}'s consensus_hash — refusing to relay")
        return res

    async def abci_query(self, ctx, path="", data="", height=0,
                         prove=True) -> dict:
        """Query the primary and PROVE the answer against the
        light-verified app hash (reference light/rpc/client.go:104-151
        ABCIQueryWithOptions): prove is forced on, the response must
        carry proof ops, and the value (or its absence) is verified
        via the ProofRuntime against header(resp.height+1).app_hash —
        the app hash for height H lives in header H+1. A tampered
        value, forged proof, or proof against the wrong state fails
        here instead of reaching the caller."""
        import base64

        from ..rpc.core import hexbytes_param

        # Decode once (hex / 0x-hex / URI-quoted raw) and forward as
        # plain hex so the primary sees one canonical form.
        want = hexbytes_param(data)
        res = await self._forwarder("abci_query")(
            ctx, path=path, data=want.hex(), height=height, prove=True)
        resp = res.get("response", {})
        if int(resp.get("code", 0)) != 0:
            raise RPCError(-32603,
                           f"err response code: {resp.get('code')}")
        key = base64.b64decode(resp.get("key") or "")
        if not key:
            raise RPCError(-32603, "empty key in query response")
        # The proof must be about the key WE asked for — a primary
        # that answers with a different key (and a perfectly valid
        # proof for it) must not pass.
        if key != want:
            raise RPCError(
                -32603,
                f"primary answered for key {key.hex()[:16]}… but "
                f"{want.hex()[:16]}… was queried")
        ops_json = (resp.get("proof_ops") or {}).get("ops") or []
        if not ops_json:
            raise RPCError(
                -32603, "no proof ops in query response (the app must "
                "support Prove=true for verified queries)")
        h = int(resp.get("height") or 0)
        if h <= 0:
            raise RPCError(-32603, "zero or negative query height")
        # The app hash for state h is committed in header h+1, which
        # may be one block-time away when the query hits the app's
        # live head — absorb only THAT race (block-not-found) with a
        # bounded wait; verification failures are deterministic and
        # surface immediately.
        import asyncio

        deadline = asyncio.get_running_loop().time() + 5.0
        while True:
            try:
                if self.plane is not None:
                    lb = await self.plane.get_verified(h + 1)
                else:
                    lb = await self.client.verify_light_block_at_height(
                        h + 1)
                break
            except BlockNotFoundError as e:
                if asyncio.get_running_loop().time() >= deadline:
                    raise RPCError(
                        -32603, f"header {h + 1} (carrying the app "
                        f"hash for query height {h}) not available: {e}")
                await asyncio.sleep(0.2)
            except LightServingShedError as e:
                # same shed-to-429 mapping as _verified_block_at:
                # backpressure, not a verdict (clause order matters —
                # the shed error IS a LightClientError)
                from ..rpc.jsonrpc import CODE_BUSY

                raise RPCError(CODE_BUSY, str(e), "queue_full")
            except LightClientError as e:
                raise RPCError(-32603, f"light verification failed: {e}")
        app_hash = lb.signed_header.header.app_hash
        from ..crypto.merkle import ProofOp

        ops = [ProofOp(o["type"], base64.b64decode(o.get("key") or ""),
                       base64.b64decode(o.get("data") or ""))
               for o in ops_json]
        value = base64.b64decode(resp.get("value") or "")
        rt = self._proof_runtime()
        if value:
            ok = rt.verify_value(ops, app_hash, [key], value)
        else:
            # An empty value is EITHER a proven absence OR a key
            # legitimately stored with an empty value — b64 JSON
            # cannot carry the reference's nil-vs-empty distinction,
            # so accept whichever proof the app sent; both pin the
            # relayed (empty) answer to the trusted root.
            ok = rt.verify_absence(ops, app_hash, [key]) or \
                rt.verify_value(ops, app_hash, [key], b"")
        if not ok:
            raise RPCError(
                -32603,
                f"proof verification failed for key {key.hex()[:16]}… "
                f"against app_hash of verified header {h + 1} — "
                "refusing to relay an unproven query result")
        return res

    def _proof_runtime(self):
        if getattr(self, "_prt", None) is None:
            from ..abci.kv_proofs import kv_proof_runtime

            self._prt = kv_proof_runtime()
        return self._prt

    # -- websocket subscriptions (reference light/proxy/routes.go
    #    subscribe/unsubscribe: relayed through the primary's event
    #    stream; events are inherently unverifiable live data, same
    #    trust level as the reference's passthrough) --

    def _ws_routes(self) -> dict:
        if self.forward is None or not hasattr(self.forward, "host"):
            return {}
        return {"subscribe": self.subscribe,
                "unsubscribe": self.unsubscribe,
                "unsubscribe_all": self.unsubscribe_all}

    MAX_SUBSCRIPTIONS_PER_CLIENT = 5  # same bound as RPCConfig

    async def subscribe(self, ctx, query="") -> dict:
        import asyncio

        from ..rpc.jsonrpc import WSClient, relay_events

        ws = ctx.ws
        if ws is None:
            raise RPCError(-32603, "subscribe requires a websocket")
        subs = getattr(ws, "_lp_subs", None)
        if subs is None:
            subs = ws._lp_subs = {}
        if query in subs:
            raise RPCError(-32603, f"already subscribed to {query!r}")
        if len(subs) >= self.MAX_SUBSCRIPTIONS_PER_CLIENT:
            # each subscription costs an upstream TCP+WS connection;
            # an unbounded loop over distinct queries must not
            # exhaust fds on proxy or primary
            raise RPCError(-32603, "too many subscriptions")
        up = WSClient(self.forward.host, self.forward.port)
        try:
            # bounded: the handler runs inline in the ws read loop, so
            # a blackholed primary must not wedge this client's socket
            await asyncio.wait_for(up.connect(), 10)
            await up.call("subscribe", query=query)
        except BaseException:
            up.close()
            raise
        task = asyncio.get_running_loop().create_task(
            relay_events(ws, up.events.get), name=f"lp-ws-sub-{id(ws)}")
        subs[query] = (up, task)
        return {}

    async def unsubscribe(self, ctx, query="") -> dict:
        ws = ctx.ws
        subs = getattr(ws, "_lp_subs", {}) if ws else {}
        ent = subs.pop(query, None)
        if ent is None:
            raise RPCError(-32603, f"not subscribed to {query!r}")
        up, task = ent
        task.cancel()
        up.close()
        return {}

    async def unsubscribe_all(self, ctx) -> dict:
        ws = ctx.ws
        for up, task in getattr(ws, "_lp_subs", {}).values():
            task.cancel()
            up.close()
        if ws is not None:
            ws._lp_subs = {}
        return {}

    def _on_ws_close(self, ws) -> None:
        for up, task in getattr(ws, "_lp_subs", {}).values():
            task.cancel()
            up.close()

    # -- pass-through routes --

    def _forwarder(self, name: str):
        async def fwd(ctx, **params):
            from ..rpc.jsonrpc import RPCError as ClientRPCError

            try:
                return await self.forward.call(name, **params)
            except ClientRPCError as e:
                raise RPCError(e.code, e.message, e.data)
            except OSError as e:
                raise RPCError(-32603, f"primary unreachable: {e}")

        return fwd
