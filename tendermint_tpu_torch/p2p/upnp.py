"""UPnP IGD port mapping (reference: tendermint_tpu/p2p/upnp.py, copied;
Go p2p/upnp/upnp.go — SSDP discovery
+ WANIPConnection SOAP control, used by `probe-upnp` and the switch's
optional NAT traversal).

Protocol surface implemented with stdlib only:
  discover()            M-SEARCH over UDP multicast 239.255.255.250:1900,
                        parse LOCATION, fetch the device description
                        XML, find the WANIPConnection control URL
  external_ip()         GetExternalIPAddress SOAP action
  add_port_mapping()    AddPortMapping
  delete_port_mapping() DeletePortMapping

Test hook: `discover(ssdp_addr=..., timeout=...)` accepts a unicast
address so an in-process fake IGD can serve the whole flow
(tests/test_torch_upnp.py) without multicast or a real gateway.
"""

from __future__ import annotations

import asyncio
import socket
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from dataclasses import dataclass

SSDP_ADDR = ("239.255.255.250", 1900)
_ST = "urn:schemas-upnp-org:device:InternetGatewayDevice:1"
_WANIP = "urn:schemas-upnp-org:service:WANIPConnection:1"


class UPnPError(Exception):
    pass


@dataclass
class IGD:
    """A discovered Internet Gateway Device's WANIPConnection service."""

    control_url: str
    service_type: str
    local_ip: str

    def _soap(self, action: str, body_args: str) -> str:
        envelope = (
            '<?xml version="1.0"?>'
            '<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/"'
            ' s:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">'
            "<s:Body>"
            f'<u:{action} xmlns:u="{self.service_type}">{body_args}'
            f"</u:{action}>"
            "</s:Body></s:Envelope>"
        ).encode()
        req = urllib.request.Request(
            self.control_url, data=envelope, method="POST",
            headers={
                "Content-Type": 'text/xml; charset="utf-8"',
                "SOAPAction": f'"{self.service_type}#{action}"',
            })
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.read().decode()
        except Exception as e:
            raise UPnPError(f"{action} failed: {e!r}") from e

    def external_ip(self) -> str:
        xml_text = self._soap("GetExternalIPAddress", "")
        m = _find_text(xml_text, "NewExternalIPAddress")
        if not m:
            raise UPnPError("no NewExternalIPAddress in response")
        return m

    def add_port_mapping(self, external_port: int, internal_port: int,
                         protocol: str = "TCP",
                         description: str = "tendermint-tpu",
                         lease_seconds: int = 0) -> None:
        self._soap("AddPortMapping", (
            "<NewRemoteHost></NewRemoteHost>"
            f"<NewExternalPort>{external_port}</NewExternalPort>"
            f"<NewProtocol>{protocol}</NewProtocol>"
            f"<NewInternalPort>{internal_port}</NewInternalPort>"
            f"<NewInternalClient>{self.local_ip}</NewInternalClient>"
            "<NewEnabled>1</NewEnabled>"
            f"<NewPortMappingDescription>{description}"
            "</NewPortMappingDescription>"
            f"<NewLeaseDuration>{lease_seconds}</NewLeaseDuration>"
        ))

    def delete_port_mapping(self, external_port: int,
                            protocol: str = "TCP") -> None:
        self._soap("DeletePortMapping", (
            "<NewRemoteHost></NewRemoteHost>"
            f"<NewExternalPort>{external_port}</NewExternalPort>"
            f"<NewProtocol>{protocol}</NewProtocol>"
        ))


def _find_text(xml_text: str, tag: str) -> str | None:
    """First text content of `tag` anywhere in the tree, any namespace."""
    try:
        root = ET.fromstring(xml_text)
    except ET.ParseError as e:
        raise UPnPError(f"bad XML: {e}") from e
    for el in root.iter():
        if el.tag.rsplit("}", 1)[-1] == tag:
            return (el.text or "").strip()
    return None


def _parse_description(base_url: str, xml_text: str) -> str | None:
    """Find the WANIPConnection controlURL in a device description."""
    try:
        root = ET.fromstring(xml_text)
    except ET.ParseError as e:
        raise UPnPError(f"bad device description: {e}") from e
    for svc in root.iter():
        if svc.tag.rsplit("}", 1)[-1] != "service":
            continue
        stype = curl = None
        for child in svc:
            t = child.tag.rsplit("}", 1)[-1]
            if t == "serviceType":
                stype = (child.text or "").strip()
            elif t == "controlURL":
                curl = (child.text or "").strip()
        if stype and curl and "WANIPConnection" in stype:
            return urllib.parse.urljoin(base_url, curl)
    return None


async def discover(timeout: float = 3.0,
                   ssdp_addr: tuple[str, int] = SSDP_ADDR) -> IGD:
    """SSDP M-SEARCH -> LOCATION -> description XML -> control URL."""
    loop = asyncio.get_running_loop()
    msg = (
        "M-SEARCH * HTTP/1.1\r\n"
        f"HOST: {ssdp_addr[0]}:{ssdp_addr[1]}\r\n"
        'MAN: "ssdp:discover"\r\n'
        f"ST: {_ST}\r\n"
        "MX: 2\r\n\r\n"
    ).encode()

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setblocking(False)
    try:
        sock.sendto(msg, ssdp_addr)
        try:
            data, peer = await asyncio.wait_for(
                loop.sock_recvfrom(sock, 4096), timeout)
        except asyncio.TimeoutError:
            raise UPnPError("no UPnP gateway responded") from None
        location = None
        for line in data.decode(errors="replace").split("\r\n"):
            k, _, v = line.partition(":")
            if k.strip().lower() == "location":
                location = v.strip()
        if not location:
            raise UPnPError("SSDP response without LOCATION")
        local_ip = _local_ip_toward(peer[0])
    finally:
        sock.close()

    desc = await asyncio.to_thread(_fetch, location)
    control = _parse_description(location, desc)
    if control is None:
        raise UPnPError("gateway has no WANIPConnection service")
    return IGD(control_url=control, service_type=_WANIP,
               local_ip=local_ip)


def _fetch(url: str) -> str:
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode(errors="replace")


def _local_ip_toward(peer_ip: str) -> str:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((peer_ip, 9))
        return s.getsockname()[0]
    finally:
        s.close()
