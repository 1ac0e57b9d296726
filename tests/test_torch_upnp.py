"""The port's UPnP IGD client (tendermint_tpu_torch/p2p/upnp.py) and its
`probe-upnp` command held against the JAX package's on the fake gateway
of tests/test_upnp.py (an SSDP responder and a WANIPConnection SOAP
server, both on 127.0.0.1: nothing is sent to a multicast group or any
other host). Tolerance: exact — the same discovered control URL, local
address and external address, byte-equal SOAP requests, the same errors
and the same printed JSON."""

from __future__ import annotations

import asyncio
import functools
import json
import socket
import threading
from http.server import HTTPServer

import pytest
from test_upnp import _FakeIGDHandler, _ssdp_responder

from tendermint_tpu import cmd as jcmd
from tendermint_tpu.p2p import upnp as jupnp
from tendermint_tpu_torch import cmd as pcmd
from tendermint_tpu_torch.p2p import upnp as pupnp

PKGS = {"port": pupnp, "reference": jupnp}


@pytest.fixture
def gateway():
    srv = HTTPServer(("127.0.0.1", 0), _FakeIGDHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield srv.server_port
    finally:
        srv.shutdown()
        srv.server_close()


def test_discover_and_map_ports_alike(gateway):
    got = {}
    for k, p in PKGS.items():
        ssdp = _ssdp_responder(gateway)

        async def go():
            igd = await p.discover(timeout=5.0, ssdp_addr=("127.0.0.1", ssdp))
            out = [igd.control_url, igd.service_type, igd.local_ip,
                   igd.external_ip()]
            _FakeIGDHandler.mappings.clear()
            igd.add_port_mapping(26656, 26657, "TCP", "tm-test")
            out.append(dict(_FakeIGDHandler.mappings))
            igd.delete_port_mapping(26656, "TCP")
            out.append(dict(_FakeIGDHandler.mappings))
            return out

        got[k] = asyncio.run(go())
    assert got["port"] == got["reference"]
    assert got["port"][0].endswith("/ctl/IPConn")
    assert got["port"][3] == "203.0.113.7"
    assert (26656, "TCP") in got["port"][4] and got["port"][5] == {}


def test_timeouts_and_soap_errors_alike():
    errs = {}
    for k, p in PKGS.items():
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("127.0.0.1", 0))
        try:
            with pytest.raises(p.UPnPError) as e:
                asyncio.run(p.discover(
                    timeout=0.3,
                    ssdp_addr=("127.0.0.1", sock.getsockname()[1])))
        finally:
            sock.close()
        igd = p.IGD(control_url="http://127.0.0.1:1/nothing",
                    service_type=p._WANIP, local_ip="127.0.0.1")
        with pytest.raises(p.UPnPError) as e2:
            igd.external_ip()
        errs[k] = (str(e.value), type(e2.value).__name__)
    assert errs["port"] == errs["reference"]
    assert "no UPnP gateway" in errs["port"][0]


def test_description_parsing_alike():
    from test_upnp import _DESCRIPTION

    for text in (_DESCRIPTION, "<root/>", _DESCRIPTION.replace(
            "WANIPConnection", "WANPPPConnection")):
        assert pupnp._parse_description("http://127.0.0.1:9/d.xml", text) == \
            jupnp._parse_description("http://127.0.0.1:9/d.xml", text)


def test_probe_upnp_command_prints_alike(gateway, monkeypatch, capsys):
    """`probe-upnp` of each package, its discovery pointed at the fake
    gateway's SSDP responder, then at a silent port."""
    out = {}
    for k, (c, p) in {"port": (pcmd, pupnp),
                      "reference": (jcmd, jupnp)}.items():
        ssdp = _ssdp_responder(gateway)
        monkeypatch.setattr(p, "discover", functools.partial(
            p.discover, ssdp_addr=("127.0.0.1", ssdp)))
        capsys.readouterr()
        rc = c.main(["probe-upnp", "--timeout", "5"])
        ok = (rc, json.loads(capsys.readouterr().out))
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("127.0.0.1", 0))
        monkeypatch.setattr(p, "discover", functools.partial(
            p.discover.func, ssdp_addr=("127.0.0.1",
                                        sock.getsockname()[1])))
        try:
            rc = c.main(["probe-upnp", "--timeout", "0.3"])
        finally:
            sock.close()
        out[k] = (ok, (rc, json.loads(capsys.readouterr().out)))
    assert out["port"] == out["reference"]
    (rc, doc), (rc2, doc2) = out["port"]
    assert rc == 0 and doc["success"] and doc["external_ip"] == "203.0.113.7"
    assert rc2 == 1 and doc2["success"] is False
