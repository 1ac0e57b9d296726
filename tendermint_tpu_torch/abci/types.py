"""ABCI message types + Application interface (reference: abci/types.py;
Go abci/types/). Encoded bytes equal the reference's.

Messages are dataclasses with a generic JSON wire form (bytes fields
wrapped as {"__b": base64}) — the ABCI link connects OUR node to OUR
apps, so the only requirements are framing robustness and round-trip
fidelity, not consensus-critical canonical encoding (which lives in
types/canonical.py). Each message knows its wire name; the codec
registry maps names back to classes.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field, fields, is_dataclass

CODE_TYPE_OK = 0


class CheckTxType:
    NEW = 0
    RECHECK = 1


# --- auxiliary structures ----------------------------------------------------


@dataclass
class ValidatorUpdate:
    """Valset delta returned by InitChain/EndBlock (abci/types/types.pb.go
    ValidatorUpdate): pub_key + new absolute power (0 = remove)."""

    pub_key_type: str
    pub_key: bytes
    power: int


@dataclass
class VoteInfo:
    """Who signed the last block (BeginBlock.LastCommitInfo entry)."""

    address: bytes
    power: int
    signed_last_block: bool


@dataclass
class LastCommitInfo:
    round: int = 0
    votes: list[VoteInfo] = field(default_factory=list)


@dataclass
class Misbehavior:
    """Evidence forwarded to the app in BeginBlock (abci Evidence msg)."""

    type: str  # "DUPLICATE_VOTE" | "LIGHT_CLIENT_ATTACK"
    validator_address: bytes
    validator_power: int
    height: int
    time: int
    total_voting_power: int


@dataclass
class Snapshot:
    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes = b""


# --- requests ----------------------------------------------------------------


@dataclass
class RequestEcho:
    message: str = ""


@dataclass
class RequestFlush:
    pass


@dataclass
class RequestInfo:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0


@dataclass
class RequestInitChain:
    time: int = 0
    chain_id: str = ""
    consensus_params: dict | None = None
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""
    initial_height: int = 1


@dataclass
class RequestQuery:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass
class RequestBeginBlock:
    hash: bytes = b""
    header: dict = field(default_factory=dict)
    last_commit_info: LastCommitInfo = field(default_factory=LastCommitInfo)
    byzantine_validators: list[Misbehavior] = field(default_factory=list)


@dataclass
class RequestCheckTx:
    tx: bytes = b""
    type: int = CheckTxType.NEW


@dataclass
class RequestDeliverTx:
    tx: bytes = b""


@dataclass
class RequestEndBlock:
    height: int = 0


@dataclass
class RequestCommit:
    pass


@dataclass
class RequestListSnapshots:
    pass


@dataclass
class RequestOfferSnapshot:
    snapshot: Snapshot | None = None
    app_hash: bytes = b""


@dataclass
class RequestLoadSnapshotChunk:
    height: int = 0
    format: int = 0
    chunk: int = 0


@dataclass
class RequestApplySnapshotChunk:
    index: int = 0
    chunk: bytes = b""
    sender: str = ""


# --- responses ---------------------------------------------------------------


@dataclass
class ResponseEcho:
    message: str = ""


@dataclass
class ResponseFlush:
    pass


@dataclass
class ResponseException:
    error: str = ""


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class ResponseInitChain:
    consensus_params: dict | None = None
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_hash: bytes = b""


@dataclass
class ResponseQuery:
    code: int = CODE_TYPE_OK
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof_ops: list = field(default_factory=list)
    height: int = 0
    codespace: str = ""


@dataclass
class ResponseBeginBlock:
    events: list = field(default_factory=list)


@dataclass
class ResponseCheckTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list = field(default_factory=list)
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class ResponseDeliverTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list = field(default_factory=list)
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class ResponseEndBlock:
    validator_updates: list[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: dict | None = None
    events: list = field(default_factory=list)


@dataclass
class ResponseCommit:
    data: bytes = b""  # the app hash
    retain_height: int = 0


@dataclass
class ResponseListSnapshots:
    snapshots: list[Snapshot] = field(default_factory=list)


class OfferSnapshotResult:
    UNKNOWN = 0
    ACCEPT = 1
    ABORT = 2
    REJECT = 3
    REJECT_FORMAT = 4
    REJECT_SENDER = 5


@dataclass
class ResponseOfferSnapshot:
    result: int = OfferSnapshotResult.UNKNOWN


@dataclass
class ResponseLoadSnapshotChunk:
    chunk: bytes = b""


class ApplySnapshotChunkResult:
    UNKNOWN = 0
    ACCEPT = 1
    ABORT = 2
    RETRY = 3
    RETRY_SNAPSHOT = 4
    REJECT_SNAPSHOT = 5


@dataclass
class ResponseApplySnapshotChunk:
    result: int = ApplySnapshotChunkResult.UNKNOWN
    refetch_chunks: list[int] = field(default_factory=list)
    reject_senders: list[str] = field(default_factory=list)


# --- wire codec --------------------------------------------------------------

_REGISTRY: dict[str, type] = {}
_NESTED = {
    "validators": ValidatorUpdate,
    "validator_updates": ValidatorUpdate,
    "votes": VoteInfo,
    "byzantine_validators": Misbehavior,
    "snapshots": Snapshot,
    "last_commit_info": LastCommitInfo,
    "snapshot": Snapshot,
}


def _wire_name(cls: type) -> str:
    return cls.__name__


for _cls in list(globals().values()):
    if is_dataclass(_cls) and isinstance(_cls, type):
        _REGISTRY[_wire_name(_cls)] = _cls


def _jsonable(v):
    if isinstance(v, bytes):
        return {"__b": base64.b64encode(v).decode()}
    if is_dataclass(v) and not isinstance(v, type):
        return {f.name: _jsonable(getattr(v, f.name)) for f in fields(v)}
    if isinstance(v, list):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v


def _unjson(v, hint: type | None = None):
    if isinstance(v, dict) and set(v) == {"__b"}:
        return base64.b64decode(v["__b"])
    if hint is not None and isinstance(v, dict):
        kw = {}
        hints = {f.name: f for f in fields(hint)}
        for k, x in v.items():
            if k in hints:
                kw[k] = _unjson(x, _NESTED.get(k))
        return hint(**kw)
    if isinstance(v, list):
        return [_unjson(x, hint) for x in v]
    if isinstance(v, dict):
        return {k: _unjson(x) for k, x in v.items()}
    return v


def encode_msg(obj) -> bytes:
    return json.dumps(
        {"@": _wire_name(type(obj)), **_jsonable(obj)},
        separators=(",", ":"),
    ).encode()


def decode_msg(data: bytes):
    d = json.loads(data)
    name = d.pop("@")
    cls = _REGISTRY[name]
    kw = {}
    hints = {f.name: f for f in fields(cls)}
    for k, v in d.items():
        if k in hints:
            kw[k] = _unjson(v, _NESTED.get(k))
    return cls(**kw)


# --- the Application interface (reference: abci/types/application.go:11-31) --


class Application:
    """Synchronous app contract; transports call these serially per
    connection. Defaults are no-ops so apps override what they need
    (reference: abci/types/application.go BaseApplication)."""

    # group 1: info/query
    def info(self, req: RequestInfo) -> ResponseInfo:
        return ResponseInfo()

    def query(self, req: RequestQuery) -> ResponseQuery:
        return ResponseQuery()

    # group 2: mempool
    def check_tx(self, req: RequestCheckTx) -> ResponseCheckTx:
        return ResponseCheckTx()

    # group 3: consensus
    def init_chain(self, req: RequestInitChain) -> ResponseInitChain:
        return ResponseInitChain()

    def begin_block(self, req: RequestBeginBlock) -> ResponseBeginBlock:
        return ResponseBeginBlock()

    def deliver_tx(self, req: RequestDeliverTx) -> ResponseDeliverTx:
        return ResponseDeliverTx()

    def end_block(self, req: RequestEndBlock) -> ResponseEndBlock:
        return ResponseEndBlock()

    def commit(self, req: RequestCommit) -> ResponseCommit:
        return ResponseCommit()

    # group 4: state sync
    def list_snapshots(self, req: RequestListSnapshots) -> ResponseListSnapshots:
        return ResponseListSnapshots()

    def offer_snapshot(self, req: RequestOfferSnapshot) -> ResponseOfferSnapshot:
        return ResponseOfferSnapshot()

    def load_snapshot_chunk(
        self, req: RequestLoadSnapshotChunk
    ) -> ResponseLoadSnapshotChunk:
        return ResponseLoadSnapshotChunk()

    def apply_snapshot_chunk(
        self, req: RequestApplySnapshotChunk
    ) -> ResponseApplySnapshotChunk:
        return ResponseApplySnapshotChunk()


# request type -> (app method name, response class); Echo/Flush are
# handled by the transports themselves.
HANDLERS: dict[type, str] = {
    RequestInfo: "info",
    RequestQuery: "query",
    RequestCheckTx: "check_tx",
    RequestInitChain: "init_chain",
    RequestBeginBlock: "begin_block",
    RequestDeliverTx: "deliver_tx",
    RequestEndBlock: "end_block",
    RequestCommit: "commit",
    RequestListSnapshots: "list_snapshots",
    RequestOfferSnapshot: "offer_snapshot",
    RequestLoadSnapshotChunk: "load_snapshot_chunk",
    RequestApplySnapshotChunk: "apply_snapshot_chunk",
}
