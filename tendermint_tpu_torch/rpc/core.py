"""RPC route implementations bound to a node (reference: rpc/core.py;
Go rpc/core/ — routes.go:10-47, env.go:68 Environment).

Results are JSON-shaped dicts equal to the reference's; bytes render as
hex (hashes/addresses) or base64 (txs/values).

The port's fault rule (crypto/batch.py UNCAUGHT): a ``KernelError`` or
``NoDeviceError`` met under a route (``broadcast_tx_sync`` through
``check_tx`` to the admission launch, say) is never turned into an
ordinary "tx rejected" answer as the reference's routes do: it reaches
the server, which answers the request with an internal error and hands
the fault to ``Environment.on_fault``, which halts the node
(``Switch.halt``). ``broadcast_tx_async``'s background ``check_tx``
hands it there too."""

from __future__ import annotations

import asyncio
import base64

from ..abci import types as abci
from ..crypto import tmhash
from ..crypto.batch import UNCAUGHT
from ..libs.pubsub import Query
from ..types.events import (
    EventDataNewBlock, EventDataTx, query_for_event,
)
from .jsonrpc import RawStr, RPCError, UriStr

_SUBSCRIBER_PREFIX = "ws-"


def _tx_bytes(v) -> bytes:
    """Byte-typed RPC param from either transport (reference: the URI
    handler decodes quoted values as raw content and 0x-values as hex,
    while JSON-RPC carries []byte base64-encoded). RawStr marks a
    URI-quoted value; `curl '...?tx="k=v"'` is the documented usage."""
    if isinstance(v, bytes):
        return v
    if isinstance(v, RawStr):
        return v.encode()
    if isinstance(v, UriStr) and v.startswith("0x"):
        # URI-only: a JSON-RPC base64 payload that happens to look
        # like 0x-hex must not be hex-decoded. Malformed hex is an
        # error, not a base64 fallback (a typo'd hex tx that survives
        # base64 decoding would broadcast garbage bytes).
        try:
            return bytes.fromhex(v[2:])
        except ValueError as e:
            raise RPCError(-32602, "invalid 0x-hex byte param") from e
    try:
        return base64.b64decode(v, validate=True)
    except Exception as e:
        raise RPCError(
            -32602,
            "invalid byte param: expected base64 (JSON-RPC), a "
            '"quoted" raw string, or 0x-hex (URI)') from e


def coerce_hex_param(data) -> str:
    """All-digit hex strings arrive int-coerced from URI params;
    re-render losslessly (hex data always has even length, so a
    leading zero is the only ambiguity — restore it by parity).
    Shared by the node's abci_query and the light proxy's key check."""
    if isinstance(data, int):
        data = str(data)
        if len(data) % 2:
            data = "0" + data
    return data


def hexbytes_param(data) -> bytes:
    """HexBytes-typed RPC param (abci_query data): hex string from
    JSON-RPC (the reference's HexBytes JSON encoding), while the URI
    handler passes "quoted" values as RAW content and 0x-values as
    hex. Shared with the light proxy's verified abci_query."""
    if isinstance(data, bytes):
        return data
    if isinstance(data, RawStr):
        return data.encode()
    data = coerce_hex_param(data)
    if not data:
        return b""
    if data.startswith("0x"):
        data = data[2:]
    try:
        return bytes.fromhex(data)
    except ValueError as e:
        raise RPCError(
            -32602,
            'invalid hex-bytes param: expected hex, 0x-hex, or a '
            '"quoted" raw string (URI)') from e


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _hex(b: bytes) -> str:
    return b.hex().upper()


def _header_json(h) -> dict:
    return {
        "version": {"block": h.version_block, "app": h.version_app},
        "chain_id": h.chain_id,
        "height": str(h.height),
        "time": str(h.time),
        "last_block_id": _block_id_json(h.last_block_id),
        "last_commit_hash": _hex(h.last_commit_hash),
        "data_hash": _hex(h.data_hash),
        "validators_hash": _hex(h.validators_hash),
        "next_validators_hash": _hex(h.next_validators_hash),
        "consensus_hash": _hex(h.consensus_hash),
        "app_hash": _hex(h.app_hash),
        "last_results_hash": _hex(h.last_results_hash),
        "evidence_hash": _hex(h.evidence_hash),
        "proposer_address": _hex(h.proposer_address),
    }


def _block_id_json(bid) -> dict:
    if bid is None:
        return {"hash": "", "parts": {"total": 0, "hash": ""}}
    psh = bid.part_set_header
    return {"hash": _hex(bid.hash),
            "parts": {"total": psh.total if psh else 0,
                      "hash": _hex(psh.hash) if psh else ""}}


def _commit_json(c) -> dict:
    if c is None:
        return None
    return {
        "height": str(c.height), "round": c.round,
        "block_id": _block_id_json(c.block_id),
        "signatures": [{
            "block_id_flag": s.block_id_flag,
            "validator_address": _hex(s.validator_address),
            "timestamp": str(s.timestamp),
            "signature": _b64(s.signature),
        } for s in c.signatures],
    }


def _block_json(b) -> dict:
    return {
        "header": _header_json(b.header),
        "data": {"txs": [_b64(tx) for tx in b.data.txs]},
        "evidence": {"evidence": [
            {"type": type(e).__name__, "bytes": _b64(e.to_bytes())}
            for e in b.evidence.evidence]},
        "last_commit": _commit_json(b.last_commit),
    }


def _validator_json(v) -> dict:
    return {"address": _hex(v.address),
            "pub_key": {"type": "ed25519", "value": _b64(v.pub_key.bytes())},
            "voting_power": str(v.voting_power),
            "proposer_priority": str(v.proposer_priority)}


class Environment:
    """Go reference: rpc/core/env.go:68. `node` is a Node, or any object
    with the fields the called routes read (block_store, state_store,
    config.rpc, ...)."""

    def __init__(self, node):
        self.node = node
        self._next_sub = 0
        self._bg_tasks: set = set()

    def on_fault(self, exc: BaseException) -> None:
        """A port fault met under a route halts the node (its `halt`,
        Switch.halt); a node without one only answers the error."""
        halt = getattr(self.node, "halt", None)
        if halt is not None:
            halt(exc)

    # -- build the route tables --

    def routes(self) -> dict:
        return {
            "health": self.health,
            "status": self.status,
            "net_info": self.net_info,
            "genesis": self.genesis,
            "block": self.block,
            "block_by_hash": self.block_by_hash,
            "block_results": self.block_results,
            "blockchain": self.blockchain,
            "commit": self.commit,
            "validators": self.validators,
            "consensus_params": self.consensus_params,
            "consensus_state": self.consensus_state,
            "dump_consensus_state": self.dump_consensus_state,
            "abci_info": self.abci_info,
            "abci_query": self.abci_query,
            "broadcast_tx_async": self.broadcast_tx_async,
            "broadcast_tx_sync": self.broadcast_tx_sync,
            "broadcast_tx_commit": self.broadcast_tx_commit,
            "unconfirmed_txs": self.unconfirmed_txs,
            "num_unconfirmed_txs": self.num_unconfirmed_txs,
            "tx": self.tx,
            "tx_search": self.tx_search,
            "block_search": self.block_search,
            "genesis_chunked": self.genesis_chunked,
            "broadcast_evidence": self.broadcast_evidence,
            "check_tx": self.check_tx,
            # unsafe routes (reference routes.go AddUnsafeRoutes;
            # exposed only with rpc.unsafe = true)
            **({
                "unsafe_flush_mempool": self.unsafe_flush_mempool,
                "unsafe_net_sever": self.unsafe_net_sever,
                "dial_seeds": self.dial_seeds,
                "dial_peers": self.dial_peers,
            } if getattr(self.node.config.rpc, "unsafe", False) else {}),
        }

    def ws_routes(self) -> dict:
        return {
            "subscribe": self.subscribe,
            "unsubscribe": self.unsubscribe,
            "unsubscribe_all": self.unsubscribe_all,
        }

    # -- info --

    async def health(self, ctx) -> dict:
        return {}

    async def status(self, ctx) -> dict:
        n = self.node
        latest_h = n.block_store.height
        meta = n.block_store.load_block_meta(latest_h) if latest_h else None
        pv = n.priv_validator
        val_info = {}
        if pv is not None:
            addr = pv.get_pub_key().address()
            _, val = n.consensus_state.rs.validators.get_by_address(addr) \
                if n.consensus_state.rs.validators else (-1, None)
            val_info = {
                "address": _hex(addr),
                "pub_key": {"type": "ed25519",
                            "value": _b64(pv.get_pub_key().bytes())},
                "voting_power": str(val.voting_power if val else 0),
            }
        return {
            "node_info": {
                "id": n.node_key.id,
                "listen_addr": n.listen_addr,
                "network": n.genesis_doc.chain_id,
                "moniker": n.config.base.moniker,
                "version": "tendermint-tpu/0.1",
            },
            "sync_info": {
                "latest_block_height": str(latest_h),
                "latest_block_hash":
                    _hex(meta.block_id.hash) if meta else "",
                "latest_app_hash": _hex(n.state.app_hash),
                "latest_block_time":
                    str(meta.header.time) if meta else "0",
                "earliest_block_height": str(n.block_store.base),
                "catching_up": not n.bc_reactor.synced.is_set(),
            },
            "validator_info": val_info,
        }

    async def net_info(self, ctx) -> dict:
        sw = self.node.switch
        return {
            "listening": True,
            "listeners": [self.node.listen_addr],
            "n_peers": str(sw.n_peers()),
            "peers": [{
                "node_info": {"id": p.id, "moniker": p.node_info.moniker,
                              "listen_addr": p.node_info.listen_addr},
                "is_outbound": p.outbound,
                "remote_ip": p.socket_addr,
            } for p in sw.peers.values()],
        }

    async def genesis(self, ctx) -> dict:
        import json as _json

        return {"genesis": _json.loads(self.node.genesis_doc.to_json())}

    # -- blocks --

    def _height_param(self, height, default_latest=True) -> int:
        latest = self.node.block_store.height
        if height in (None, 0, "0", ""):
            if not default_latest:
                raise RPCError(-32602, "height required")
            return latest
        h = int(height)
        if h < self.node.block_store.base or h > latest:
            raise RPCError(
                -32603, f"height {h} not available "
                f"(base {self.node.block_store.base}, latest {latest})")
        return h

    async def block(self, ctx, height=None) -> dict:
        h = self._height_param(height)
        block = self.node.block_store.load_block(h)
        meta = self.node.block_store.load_block_meta(h)
        if block is None or meta is None:
            raise RPCError(-32603, f"no block at height {h}")
        return {"block_id": _block_id_json(meta.block_id),
                "block": _block_json(block)}

    async def block_by_hash(self, ctx, hash=None) -> dict:
        if not hash:
            raise RPCError(-32602, "hash required")
        block = self.node.block_store.load_block_by_hash(
            bytes.fromhex(hash))
        if block is None:
            raise RPCError(-32603, f"block {hash} not found")
        return await self.block(ctx, height=block.header.height)

    async def block_results(self, ctx, height=None) -> dict:
        h = self._height_param(height)
        resp = self.node.state_store.load_abci_responses(h)
        if resp is None:
            raise RPCError(-32603, f"no results for height {h}")
        deliver = [
            {"code": getattr(r, "code", 0),
             "data": _b64(getattr(r, "data", b"") or b""),
             "log": getattr(r, "log", ""),
             "gas_wanted": str(getattr(r, "gas_wanted", 0)),
             "gas_used": str(getattr(r, "gas_used", 0)),
             "events": getattr(r, "events", [])}
            for r in resp.get("deliver_txs", [])
        ]
        end = resp.get("end_block")
        return {
            "height": str(h),
            "txs_results": deliver,
            "validator_updates": [
                {"pub_key": _b64(vu.pub_key), "power": str(vu.power)}
                for vu in (end.validator_updates if end else [])],
        }

    async def blockchain(self, ctx, min_height=None, max_height=None) -> dict:
        store = self.node.block_store
        max_h = self._height_param(max_height)
        min_h = max(int(min_height or 1), store.base)
        min_h = max(min_h, max_h - 19)  # reference caps at 20 metas
        metas = []
        for h in range(max_h, min_h - 1, -1):
            m = store.load_block_meta(h)
            if m is not None:
                metas.append({
                    "block_id": _block_id_json(m.block_id),
                    "block_size": str(m.block_size),
                    "header": _header_json(m.header),
                    "num_txs": str(m.num_txs),
                })
        return {"last_height": str(store.height), "block_metas": metas}

    async def commit(self, ctx, height=None) -> dict:
        h = self._height_param(height)
        store = self.node.block_store
        meta = store.load_block_meta(h)
        if meta is None:
            raise RPCError(-32603, f"no block at height {h}")
        commit = store.load_block_commit(h)
        canonical = True
        if commit is None:
            commit = store.load_seen_commit(h)
            canonical = False
        return {
            "signed_header": {"header": _header_json(meta.header),
                              "commit": _commit_json(commit)},
            "canonical": canonical,
        }

    async def validators(self, ctx, height=None, page=1,
                         per_page=30) -> dict:
        h = self._height_param(height)
        vals = self.node.state_store.load_validators(h)
        if vals is None:
            raise RPCError(-32603, f"no validators for height {h}")
        page, per_page = max(int(page), 1), min(max(int(per_page), 1), 100)
        start = (page - 1) * per_page
        sel = vals.validators[start:start + per_page]
        return {"block_height": str(h),
                "validators": [_validator_json(v) for v in sel],
                "count": str(len(sel)), "total": str(len(vals))}

    async def consensus_params(self, ctx, height=None) -> dict:
        h = self._height_param(height)
        params = self.node.state_store.load_consensus_params(h) or \
            self.node.state.consensus_params
        return {
            "block_height": str(h),
            "consensus_params": {
                "block": {"max_bytes": str(params.block.max_bytes),
                          "max_gas": str(params.block.max_gas)},
                "evidence": {
                    "max_age_num_blocks":
                        str(params.evidence.max_age_num_blocks),
                    "max_age_duration":
                        str(params.evidence.max_age_duration_ns),
                    "max_bytes": str(params.evidence.max_bytes)},
                "validator": {
                    "pub_key_types": params.validator.pub_key_types},
                "version": {
                    "app_version": str(params.version.app_version)},
            },
        }

    async def consensus_state(self, ctx) -> dict:
        rs = self.node.consensus_state.rs
        return {"round_state": {
            "height": str(rs.height), "round": rs.round,
            "step": int(rs.step),
            "start_time": str(rs.start_time),
            "proposal_block_hash":
                _hex(rs.proposal_block.hash()) if rs.proposal_block
                else "",
            "locked_block_hash":
                _hex(rs.locked_block.hash()) if rs.locked_block else "",
            "valid_block_hash":
                _hex(rs.valid_block.hash()) if rs.valid_block else "",
        }}

    async def dump_consensus_state(self, ctx) -> dict:
        base = await self.consensus_state(ctx)
        rs = self.node.consensus_state.rs
        # Per-round vote tallies (reference dump includes the
        # HeightVoteSet's bit-array renderings).
        votes = []
        if rs.votes is not None:
            for rnd in sorted(rs.votes._round_vote_sets):
                pv = rs.votes.prevotes(rnd)
                pc = rs.votes.precommits(rnd)
                votes.append({
                    "round": rnd,
                    "prevotes": str(pv.bit_array()) if pv else "",
                    "prevotes_power": str(pv.sum if pv else 0),
                    "precommits": str(pc.bit_array()) if pc else "",
                    "precommits_power": str(pc.sum if pc else 0),
                })
        base["round_state"]["height_vote_set"] = votes
        reactor = self.node.consensus_reactor
        base["peers"] = [{
            "node_address": pid,
            "peer_state": {"height": str(ps.height), "round": ps.round,
                           "step": int(ps.step)},
        } for pid, ps in reactor.peer_states.items()]
        return base

    # -- abci --

    async def abci_info(self, ctx) -> dict:
        res = await self.node.proxy_app.query.info(abci.RequestInfo())
        return {"response": {
            "data": res.data, "version": res.version,
            "app_version": str(res.app_version),
            "last_block_height": str(res.last_block_height),
            "last_block_app_hash": _b64(res.last_block_app_hash),
        }}

    async def abci_query(self, ctx, path="", data="", height=0,
                         prove=False) -> dict:
        res = await self.node.proxy_app.query.query(abci.RequestQuery(
            data=hexbytes_param(data),
            path=path, height=int(height), prove=bool(prove)))
        out = {
            "code": res.code, "log": res.log, "index": str(res.index),
            "key": _b64(res.key or b""), "value": _b64(res.value or b""),
            "height": str(res.height),
        }
        if res.proof_ops:
            out["proof_ops"] = {"ops": [
                {"type": op["type"], "key": _b64(op["key"]),
                 "data": _b64(op["data"])} for op in res.proof_ops]}
        return {"response": out}

    # -- txs --

    @staticmethod
    def _busy_error(e: Exception) -> RPCError:
        """Admission sheds surface as explicit 429-style errors so a
        load generator can distinguish 'back off' from 'bad tx'."""
        from .jsonrpc import CODE_BUSY

        return RPCError(CODE_BUSY, f"mempool overloaded: {e}")

    async def broadcast_tx_async(self, ctx, tx="") -> dict:
        raw = _tx_bytes(tx)
        # Preflight admission: fire-and-forget must still SHED visibly
        # when the pool/app window is saturated — silently spawning a
        # doomed CheckTx task hides overload from the one caller who
        # could slow down.
        mp = self.node.mempool
        admission_err = getattr(mp, "admission_error",
                                lambda n=0, tx=None: None)(len(raw), raw)
        if admission_err is not None:
            # count the shed here: the CheckTx task that would have
            # recorded it is never spawned, and a flood rejected only
            # on this path must still move overload_shed_total and
            # the /status level (parity with broadcast_tx_sync) —
            # same routing as check_tx via shed_admission_error
            mp.shed_admission_error(admission_err)
            raise self._busy_error(admission_err)
        # hold a strong ref: the loop only weak-refs tasks, and a GC'd
        # task would silently drop the tx
        task = asyncio.get_running_loop().create_task(
            self._checked_check_tx(raw))
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)
        return {"code": 0, "data": "", "log": "",
                "hash": _hex(tmhash.sum256(raw))}

    async def _checked_check_tx(self, raw: bytes):
        try:
            return await self.node.mempool.check_tx(raw)
        except UNCAUGHT as e:
            self.on_fault(e)
            return e
        except Exception as e:
            return e

    async def broadcast_tx_sync(self, ctx, tx="") -> dict:
        from ..mempool.admission import AdmissionQueueFullError
        from ..mempool.clist_mempool import MempoolBusyError, \
            MempoolFullError

        raw = _tx_bytes(tx)
        try:
            res = await self.node.mempool.check_tx(raw)
        except (MempoolBusyError, MempoolFullError,
                AdmissionQueueFullError) as e:
            raise self._busy_error(e) from e
        except UNCAUGHT:
            raise
        except Exception as e:
            raise RPCError(-32603, f"tx rejected: {e}") from e
        return {"code": res.code, "data": _b64(res.data or b""),
                "log": res.log, "hash": _hex(tmhash.sum256(raw))}

    async def check_tx(self, ctx, tx="") -> dict:
        """Run CheckTx against the app WITHOUT adding to the mempool
        (reference: rpc/core/mempool.go CheckTx)."""
        from ..abci.types import RequestCheckTx

        raw = _tx_bytes(tx)
        res = await self.node.proxy_app.mempool.check_tx(
            RequestCheckTx(raw))
        return {"code": res.code, "data": _b64(res.data or b""),
                "log": res.log, "gas_wanted": str(res.gas_wanted),
                "gas_used": str(res.gas_used)}

    async def unsafe_flush_mempool(self, ctx) -> dict:
        """reference: rpc/core/mempool.go UnsafeFlushMempool."""
        await self.node.mempool.flush()
        return {}

    async def unsafe_net_sever(self, ctx, seconds="3") -> dict:
        """Test hook (no reference route — the reference e2e runner
        severs the docker network instead, perturb.go:12-60): hard-drop
        every p2p connection and refuse dials/accepts for `seconds`,
        so peers observe connection loss (not a stall) and the
        reconnect/backoff/PEX paths run for real."""
        secs = float(seconds)
        if not 0 < secs <= 60:
            raise RPCError(-32602, "seconds must be in (0, 60]")
        dropped = await self.node.switch.sever(secs)
        return {"severed_for": secs, "connections_dropped": dropped}

    async def dial_seeds(self, ctx, seeds=()) -> dict:
        """reference: rpc/core/net.go UnsafeDialSeeds."""
        if not seeds:
            raise RPCError(-32602, "no seeds provided")
        await self.node.switch.dial_peers_async(list(seeds))
        return {"log": f"dialing seeds in progress. see /net_info "
                       f"for details ({len(seeds)})"}

    async def dial_peers(self, ctx, peers=(), persistent=False) -> dict:
        """reference: rpc/core/net.go UnsafeDialPeers."""
        if not peers:
            raise RPCError(-32602, "no peers provided")
        if persistent:
            self.node.switch.add_persistent_peers(list(peers))
        await self.node.switch.dial_peers_async(list(peers))
        return {"log": f"dialing peers in progress ({len(peers)})"}

    async def broadcast_tx_commit(self, ctx, tx="") -> dict:
        """CheckTx, then wait for the tx to land in a block
        (reference: rpc/core/mempool.go BroadcastTxCommit)."""
        raw = _tx_bytes(tx)
        h = tmhash.sum256(raw)
        bus = self.node.event_bus
        subscriber = f"tx-commit-{h.hex()[:16]}"
        sub = bus.subscribe(subscriber, query_for_event("Tx"))
        try:
            from ..mempool.admission import AdmissionQueueFullError
            from ..mempool.clist_mempool import MempoolBusyError, \
                MempoolFullError

            try:
                check = await self.node.mempool.check_tx(raw)
            except (MempoolBusyError, MempoolFullError,
                    AdmissionQueueFullError) as e:
                raise self._busy_error(e) from e
            except UNCAUGHT:
                raise
            except Exception as e:
                raise RPCError(-32603, f"tx rejected: {e}") from e
            if check.code != abci.CODE_TYPE_OK:
                return {"check_tx": {"code": check.code, "log": check.log},
                        "deliver_tx": {}, "hash": _hex(h), "height": "0"}
            timeout = self.node.config.rpc.\
                timeout_broadcast_tx_commit_ms / 1000.0
            deadline = asyncio.get_running_loop().time() + timeout
            while True:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    raise RPCError(-32603,
                                   "timed out waiting for tx commit")
                try:
                    msg = await asyncio.wait_for(sub.next(), remaining)
                except asyncio.TimeoutError:
                    raise RPCError(
                        -32603, "timed out waiting for tx commit") from None
                data = msg.data
                if isinstance(data, EventDataTx) and data.tx == raw:
                    r = data.result
                    return {
                        "check_tx": {"code": check.code, "log": check.log},
                        "deliver_tx": {
                            "code": r.get("code", 0),
                            "log": r.get("log", ""),
                            "events": r.get("events", [])},
                        "hash": _hex(h),
                        "height": str(data.height),
                    }
        finally:
            bus.unsubscribe_all(subscriber)

    async def unconfirmed_txs(self, ctx, limit=30) -> dict:
        txs = self.node.mempool.reap_max_txs(min(int(limit), 100))
        return {"n_txs": str(len(txs)),
                "total": str(self.node.mempool.size()),
                "total_bytes": str(self.node.mempool.tx_bytes()),
                "txs": [_b64(t) for t in txs]}

    async def num_unconfirmed_txs(self, ctx) -> dict:
        return {"n_txs": str(self.node.mempool.size()),
                "total": str(self.node.mempool.size()),
                "total_bytes": str(self.node.mempool.tx_bytes())}

    async def tx(self, ctx, hash="", prove=False) -> dict:
        if self.node.tx_indexer is None:
            raise RPCError(-32603, "tx indexing disabled")
        tr = self.node.tx_indexer.get(bytes.fromhex(hash))
        if tr is None:
            raise RPCError(-32603, f"tx {hash} not found")
        out = {"hash": hash.upper(), "height": str(tr.height),
               "index": tr.index,
               "tx_result": tr.result, "tx": _b64(tr.tx)}
        if prove:
            block = self.node.block_store.load_block(tr.height)
            if block is not None:
                from ..crypto import merkle

                root, proofs = merkle.proofs_from_byte_slices(
                    [bytes(t) for t in block.data.txs])
                p = proofs[tr.index]
                out["proof"] = {
                    "root_hash": _hex(root),
                    "data": _b64(tr.tx),
                    "proof": {"total": p.total, "index": p.index,
                              "leaf_hash": _b64(p.leaf_hash),
                              "aunts": [_b64(a) for a in p.aunts]},
                }
        return out

    async def tx_search(self, ctx, query="", prove=False, page=1,
                        per_page=30, order_by="asc") -> dict:
        if self.node.tx_indexer is None:
            raise RPCError(-32603, "tx indexing disabled")
        results = self.node.tx_indexer.search(Query.parse(query))
        if order_by == "desc":
            results = list(reversed(results))
        page, per_page = max(int(page), 1), min(max(int(per_page), 1), 100)
        start = (page - 1) * per_page
        sel = results[start:start + per_page]
        return {"total_count": str(len(results)), "txs": [
            {"hash": _hex(t.hash()), "height": str(t.height),
             "index": t.index, "tx_result": t.result, "tx": _b64(t.tx)}
            for t in sel]}

    async def block_search(self, ctx, query="", page=1, per_page=30,
                           order_by="asc") -> dict:
        """Search blocks by BeginBlock/EndBlock events (released
        v0.34.x BlockSearch; the pinned reference predates the route —
        query language and paging match tx_search)."""
        bi = getattr(self.node, "block_indexer", None)
        if bi is None:
            raise RPCError(-32603, "block indexing disabled")
        heights = bi.search(Query.parse(query))
        if order_by == "desc":
            heights = list(reversed(heights))
        page, per_page = max(int(page), 1), min(max(int(per_page), 1), 100)
        start = (page - 1) * per_page
        blocks = []
        for h in heights[start:start + per_page]:
            meta = self.node.block_store.load_block_meta(h)
            block = self.node.block_store.load_block(h)
            if meta is None or block is None:
                continue
            blocks.append({"block_id": _block_id_json(meta.block_id),
                           "block": _block_json(block)})
        return {"total_count": str(len(heights)), "blocks": blocks}

    _GENESIS_CHUNK = 16 * 1024 * 1024

    async def genesis_chunked(self, ctx, chunk=0) -> dict:
        """Paged genesis download for documents too big for one
        response (released v0.34.x GenesisChunked; 16 MiB chunks).
        Chunks are computed once — the genesis doc is immutable, and a
        big doc is the only reason this route gets called."""
        chunks = getattr(self, "_genesis_chunks", None)
        if chunks is None:
            data = self.node.genesis_doc.to_json().encode()
            chunks = self._genesis_chunks = [
                data[i:i + self._GENESIS_CHUNK]
                for i in range(0, len(data), self._GENESIS_CHUNK)] or [b""]
        i = int(chunk)
        if not 0 <= i < len(chunks):
            raise RPCError(
                -32603, f"there are {len(chunks)} chunks, "
                f"{i} is invalid (should be between 0 and {len(chunks)-1})")
        return {"chunk": str(i), "total": str(len(chunks)),
                "data": _b64(chunks[i])}

    async def broadcast_evidence(self, ctx, evidence="") -> dict:
        from ..types.evidence import evidence_from_bytes

        ev = evidence_from_bytes(_tx_bytes(evidence))
        self.node.evpool.add_evidence(ev)
        return {"hash": _hex(ev.hash())}

    # -- subscriptions (ws only) --

    async def subscribe(self, ctx, query="") -> dict:
        if ctx.ws is None:
            raise RPCError(-32603, "subscribe requires a websocket")
        q = Query.parse(query)
        ws = ctx.ws
        subs = getattr(ws, "_subs", None)
        if subs is None:
            subs = ws._subs = {}
        if query in subs:
            raise RPCError(-32603, f"already subscribed to {query!r}")
        max_subs = self.node.config.rpc.max_subscriptions_per_client
        if len(subs) >= max_subs:
            raise RPCError(-32603, "too many subscriptions")
        self._next_sub += 1
        subscriber = f"{_SUBSCRIBER_PREFIX}{id(ws)}-{self._next_sub}"
        sub = self.node.event_bus.subscribe(subscriber, q)

        async def next_notification():
            msg = await sub.next()
            ev_name = (msg.attrs.get("tm.event") or [None])[0]
            return {
                "jsonrpc": "2.0", "id": None,
                "result": {"query": query,
                           "data": _event_json(msg.data, ev_name),
                           "events": msg.attrs},
            }

        from .jsonrpc import relay_events

        task = asyncio.get_running_loop().create_task(
            relay_events(ws, next_notification),
            name=f"ws-sub-{subscriber}")
        subs[query] = (subscriber, task)
        return {}

    async def unsubscribe(self, ctx, query="") -> dict:
        ws = ctx.ws
        subs = getattr(ws, "_subs", {}) if ws else {}
        ent = subs.pop(query, None)
        if ent is None:
            raise RPCError(-32603, f"not subscribed to {query!r}")
        subscriber, task = ent
        self.node.event_bus.unsubscribe_all(subscriber)
        task.cancel()
        return {}

    async def unsubscribe_all(self, ctx) -> dict:
        ws = ctx.ws
        for subscriber, task in getattr(ws, "_subs", {}).values():
            self.node.event_bus.unsubscribe_all(subscriber)
            task.cancel()
        if ws is not None:
            ws._subs = {}
        return {}

    def on_ws_close(self, ws) -> None:
        for subscriber, task in getattr(ws, "_subs", {}).values():
            self.node.event_bus.unsubscribe_all(subscriber)
            task.cancel()


def _event_json(data, event: str | None = None) -> dict:
    """JSON form of an event payload. `event` is the tm.event name
    from the pubsub attributes — round-state payloads share one
    dataclass across many event types (TimeoutPropose, Unlock, ...),
    so the name must come from the subscription, not the payload."""
    if isinstance(data, EventDataNewBlock):
        return {"type": "NewBlock", "block": _block_json(data.block)}
    if isinstance(data, EventDataTx):
        return {"type": "Tx", "height": str(data.height),
                "index": data.index, "tx": _b64(data.tx),
                "result": data.result}
    out = {"type": event or type(data).__name__}
    for k in ("height", "round", "step"):
        if hasattr(data, k):
            out[k] = getattr(data, k)
    return out


# --- JSON → types (for the RPC light provider) --------------------------------


def header_from_json(d: dict):
    from ..types.block import BlockID, Header, PartSetHeader

    def _bid(j):
        if not j or not j.get("hash"):
            return None
        return BlockID(bytes.fromhex(j["hash"]),
                       PartSetHeader(j["parts"]["total"],
                                     bytes.fromhex(j["parts"]["hash"])
                                     if j["parts"]["hash"] else b""))

    return Header(
        version_block=d["version"]["block"],
        version_app=d["version"]["app"],
        chain_id=d["chain_id"], height=int(d["height"]),
        time=int(d["time"]), last_block_id=_bid(d["last_block_id"]),
        last_commit_hash=bytes.fromhex(d["last_commit_hash"]),
        data_hash=bytes.fromhex(d["data_hash"]),
        validators_hash=bytes.fromhex(d["validators_hash"]),
        next_validators_hash=bytes.fromhex(d["next_validators_hash"]),
        consensus_hash=bytes.fromhex(d["consensus_hash"]),
        app_hash=bytes.fromhex(d["app_hash"]),
        last_results_hash=bytes.fromhex(d["last_results_hash"]),
        evidence_hash=bytes.fromhex(d["evidence_hash"]),
        proposer_address=bytes.fromhex(d["proposer_address"]),
    )


def commit_from_json(d: dict):
    from ..types.block import BlockID, Commit, CommitSig, PartSetHeader

    bid_j = d["block_id"]
    bid = BlockID(bytes.fromhex(bid_j["hash"]),
                  PartSetHeader(bid_j["parts"]["total"],
                                bytes.fromhex(bid_j["parts"]["hash"])))
    sigs = [CommitSig(
        block_id_flag=s["block_id_flag"],
        validator_address=bytes.fromhex(s["validator_address"]),
        timestamp=int(s["timestamp"]),
        signature=base64.b64decode(s["signature"]),
    ) for s in d["signatures"]]
    return Commit(int(d["height"]), d["round"], bid, sigs)


def validator_set_from_json(vals_json: list):
    from ..crypto.ed25519 import Ed25519PubKey
    from ..types.validator import Validator
    from ..types.validator_set import ValidatorSet

    vals = []
    for v in vals_json:
        pk = Ed25519PubKey(base64.b64decode(v["pub_key"]["value"]))
        vals.append(Validator(pk.address(), pk, int(v["voting_power"]),
                              int(v.get("proposer_priority", 0))))
    # Restore EXACTLY (order + proposer priorities): the ValidatorSet
    # constructor re-runs proposer-priority rotation, which would
    # desynchronize a state-synced node's proposer schedule from the
    # chain's (it would then reject every real proposer's signature).
    # The proposer resolves lazily from the restored priorities.
    vs = ValidatorSet([])
    vs.validators = vals
    if vals:
        vs.proposer = vs._find_proposer()  # from restored priorities
    return vs


async def serve(env: Environment, host: str, port: int):
    """Build the server and start listening; returns (server, port)."""
    from .jsonrpc import JSONRPCServer

    rpc_cfg = env.node.config.rpc
    srv = JSONRPCServer(
        env.routes(), env.ws_routes(),
        max_body=rpc_cfg.max_body_bytes,
        max_concurrent=rpc_cfg.max_concurrent_requests,
        rate_limit_rps=rpc_cfg.rate_limit_rps, on_fault=env.on_fault)
    srv._on_ws_close = env.on_ws_close
    actual = await srv.listen(host, port)
    return srv, actual
