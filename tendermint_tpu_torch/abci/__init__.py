"""ABCI — the application blockchain interface (reference: abci/).

The 12-method Application contract (Go abci/types/application.go:11-31)
in four connection groups: Info/Query, CheckTx (mempool), InitChain/
BeginBlock/DeliverTx/EndBlock/Commit (consensus), and the four
snapshot methods (statesync). Echo/Flush are transport-level.

Messages are plain dataclasses (types.py) whose JSON wire bytes equal
the reference's; the transports are in-process (client.LocalClient)
and the varint-framed socket (client.SocketClient / server.SocketServer).
The gRPC transport is not ported (ROADMAP Queue A item 9).
"""

from .types import (  # noqa: F401
    Application,
    CheckTxType,
    CODE_TYPE_OK,
    RequestBeginBlock,
    RequestCheckTx,
    RequestCommit,
    RequestDeliverTx,
    RequestEcho,
    RequestEndBlock,
    RequestInfo,
    RequestInitChain,
    RequestQuery,
    ResponseBeginBlock,
    ResponseCheckTx,
    ResponseCommit,
    ResponseDeliverTx,
    ResponseEcho,
    ResponseEndBlock,
    ResponseInfo,
    ResponseInitChain,
    ResponseQuery,
    Snapshot,
    ValidatorUpdate,
)
