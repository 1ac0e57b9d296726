"""Peer exchange: the address book and the PEX reactor (reference:
p2p/pex/)."""

from .addrbook import AddrBook
from .reactor import PEXReactor

__all__ = ["AddrBook", "PEXReactor"]
