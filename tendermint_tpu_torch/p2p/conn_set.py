"""Active-connection IP bookkeeping + inbound connection filters
(reference: p2p/conn_set.py; Go p2p/conn_set.go,
node/node.go:422-478).

Filters run at ACCEPT time, before the secret-connection handshake —
a host opening floods of inbound connections under fresh ephemeral
node keys is refused before it costs any crypto work.
"""

from __future__ import annotations

import ipaddress


class ConnFilterError(Exception):
    pass


class ConnSet:
    """Tracks the remote IP of every live inbound connection
    (reference p2p/conn_set.go ConnSet)."""

    def __init__(self):
        self._by_conn: dict[int, str] = {}
        self._ip_counts: dict[str, int] = {}

    def has_ip(self, ip: str) -> bool:
        return self._ip_counts.get(ip, 0) > 0

    def count(self, ip: str) -> int:
        return self._ip_counts.get(ip, 0)

    def add(self, conn: object, ip: str) -> None:
        self._by_conn[id(conn)] = ip
        self._ip_counts[ip] = self._ip_counts.get(ip, 0) + 1

    def remove(self, conn: object) -> None:
        ip = self._by_conn.pop(id(conn), None)
        if ip is not None:
            n = self._ip_counts.get(ip, 0) - 1
            if n <= 0:
                self._ip_counts.pop(ip, None)
            else:
                self._ip_counts[ip] = n

    def __len__(self) -> int:
        return len(self._by_conn)


def _is_loopback(ip: str) -> bool:
    try:
        return ipaddress.ip_address(ip).is_loopback
    except ValueError:
        return False


def conn_duplicate_ip_filter(conn_set: ConnSet, ip: str) -> None:
    """Reject a second live inbound connection from the same IP
    (reference p2p.ConnDuplicateIPFilter). Loopback is exempt — a
    deliberate deviation: multi-node localnets (this repo's test and
    dev topology) all share 127.0.0.1, and loopback duplication says
    nothing about Sybil floods."""
    if _is_loopback(ip):
        return
    if conn_set.has_ip(ip):
        raise ConnFilterError(f"already connected to peer with IP {ip}")
