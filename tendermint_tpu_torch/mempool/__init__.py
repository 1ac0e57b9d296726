"""Mempool interface (reference: mempool/__init__.py; Go
mempool/mempool.go).

The full concurrent-list implementation lives in clist_mempool.py;
NopMempool satisfies the executor/consensus contract for non-proposing
or test configurations."""

from __future__ import annotations

import asyncio


class TxPreCheck:
    """Size guard applied before CheckTx (reference: sm.TxPreCheck)."""

    def __init__(self, max_tx_bytes: int):
        self.max_tx_bytes = max_tx_bytes

    def __call__(self, tx: bytes) -> str | None:
        if len(tx) > self.max_tx_bytes:
            return f"tx too large ({len(tx)} > {self.max_tx_bytes})"
        return None


class TxPostCheck:
    """Gas guard applied to CheckTx responses (reference: sm.TxPostCheck)."""

    def __init__(self, max_gas: int):
        self.max_gas = max_gas

    def __call__(self, tx: bytes, res) -> str | None:
        if self.max_gas >= 0 and res.gas_wanted > self.max_gas:
            return f"gas wanted {res.gas_wanted} > block max gas {self.max_gas}"
        return None


class Mempool:
    async def check_tx(self, tx: bytes, tx_info: dict | None = None):
        raise NotImplementedError

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> list[bytes]:
        raise NotImplementedError

    def reap_max_txs(self, n: int) -> list[bytes]:
        raise NotImplementedError

    def lock(self) -> None:
        raise NotImplementedError

    def unlock(self) -> None:
        raise NotImplementedError

    async def update(self, height: int, txs: list[bytes], results: list,
                     precheck=None, postcheck=None) -> None:
        raise NotImplementedError

    async def flush_app_conn(self) -> None:
        pass

    def size(self) -> int:
        return 0

    def tx_bytes(self) -> int:
        return 0

    async def flush(self) -> None:
        pass


class NopMempool(Mempool):
    async def check_tx(self, tx: bytes, tx_info: dict | None = None):
        raise RuntimeError("NopMempool does not accept txs")

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> list[bytes]:
        return []

    def reap_max_txs(self, n: int) -> list[bytes]:
        return []

    def lock(self) -> None:
        pass

    def unlock(self) -> None:
        pass

    async def update(self, height, txs, results, precheck=None, postcheck=None):
        pass
