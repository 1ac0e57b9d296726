"""Counter example app (reference: abci/counter.py; Go
abci/example/counter/counter.go).

Txs must be the big-endian encoding of the next counter value when
serial mode is on (toggled by a 'serial=on' tx); otherwise any tx
increments the counter. Exercises CheckTx rejection + recheck."""

from __future__ import annotations

import struct

from . import types as t


class CounterApp(t.Application):
    def __init__(self, serial: bool = False):
        self.serial = serial
        self.hash_count = 0
        self.tx_count = 0

    def info(self, req: t.RequestInfo) -> t.ResponseInfo:
        return t.ResponseInfo(
            data=f"hashes:{self.hash_count}, txs:{self.tx_count}",
            last_block_height=self.hash_count,
            last_block_app_hash=self._app_hash())

    def _app_hash(self) -> bytes:
        return struct.pack(">Q", self.tx_count) if self.tx_count else b""

    def _check(self, tx: bytes) -> int | None:
        """Returns an error code or None."""
        if tx == b"serial=on":
            return None
        if self.serial:
            if len(tx) > 8:
                return 1
            if int.from_bytes(tx, "big") != self.tx_count:
                return 2
        return None

    def check_tx(self, req: t.RequestCheckTx) -> t.ResponseCheckTx:
        code = self._check(req.tx)
        if code is not None:
            return t.ResponseCheckTx(code=code, log="bad counter tx")
        return t.ResponseCheckTx(code=t.CODE_TYPE_OK, gas_wanted=1)

    def deliver_tx(self, req: t.RequestDeliverTx) -> t.ResponseDeliverTx:
        if req.tx == b"serial=on":
            self.serial = True
            return t.ResponseDeliverTx(code=t.CODE_TYPE_OK)
        code = self._check(req.tx)
        if code is not None:
            return t.ResponseDeliverTx(code=code, log="bad counter tx")
        self.tx_count += 1
        return t.ResponseDeliverTx(code=t.CODE_TYPE_OK)

    def commit(self, req: t.RequestCommit) -> t.ResponseCommit:
        self.hash_count += 1
        return t.ResponseCommit(data=self._app_hash())

    def query(self, req: t.RequestQuery) -> t.ResponseQuery:
        if req.path == "hash":
            return t.ResponseQuery(value=str(self.hash_count).encode())
        if req.path == "tx":
            return t.ResponseQuery(value=str(self.tx_count).encode())
        return t.ResponseQuery(code=1, log=f"unknown path {req.path!r}")
