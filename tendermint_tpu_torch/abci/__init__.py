"""ABCI — the application blockchain interface (reference: abci/).

The 12-method Application contract (Go abci/types/application.go:11-31)
in four connection groups: Info/Query, CheckTx (mempool), InitChain/
BeginBlock/DeliverTx/EndBlock/Commit (consensus), and the four
snapshot methods (statesync). Echo/Flush are transport-level.

Messages are plain dataclasses (types.py) whose JSON wire bytes equal
the reference's; the transport is in-process (client.LocalClient). The
socket and gRPC transports wait for a later slice of the port.
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
