"""The port's remote-signer conformance harness
(tendermint_tpu_torch/tools/signer_harness.py) against the JAX
package's (tendermint_tpu/tools/signer_harness.py).

The reference's three cases (tests/test_signer_harness.py: a
conformant FilePV signer exits 0, a MockPV signer without double-sign
protection 5, a wrong expected key 2) run on the port, and across the
packages both ways — the port's harness against the reference's
SignerServer and the reference's harness against the port's — with the
same exit codes: the privval wire is byte-compatible. The harness's CLI
with --secret-connection passes a `cmd signer --connect` child. Every
port comes from the OS."""

import asyncio

import pytest

from tendermint_tpu.privval import FilePV as RefFilePV
from tendermint_tpu.privval.signer import SignerServer as RefSignerServer
from tendermint_tpu.tools import signer_harness as ref_harness
from tendermint_tpu.types.priv_validator import MockPV as RefMockPV
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.e2e.runner import free_port
from tendermint_tpu_torch.privval import FilePV
from tendermint_tpu_torch.privval.signer import SignerServer
from tendermint_tpu_torch.tools import signer_harness
from tendermint_tpu_torch.types.priv_validator import MockPV

CHAIN = "harness-chain"
HARNESS = {"port": signer_harness, "ref": ref_harness}
SIGNER = {"port": (FilePV, MockPV, SignerServer),
          "ref": (RefFilePV, RefMockPV, RefSignerServer)}
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


def run(harness_pkg: str, signer_pkg: str, case: str, tmp_path) -> int:
    """One harness run against one signer; the exit code (0, or the
    HarnessFailure's)."""
    harness = HARNESS[harness_pkg]
    file_pv, mock_pv, server_cls = SIGNER[signer_pkg]

    async def go() -> int:
        if case == "unsafe":
            pv = mock_pv()  # no last-sign state: re-signs anything
        else:
            pv = file_pv.generate(str(tmp_path / "key.json"),
                                  str(tmp_path / "state.json"))
        expected = {"conformant": pv.get_pub_key().bytes(),
                    "unsafe": None, "wrong_key": b"\x42" * 32}[case]
        port = free_port()
        task = asyncio.create_task(harness.run_harness(
            f"127.0.0.1:{port}", CHAIN, expected_key=expected,
            timeout=20, log=lambda *a: None))
        await asyncio.sleep(0.3)
        dial = asyncio.create_task(
            server_cls(pv, CHAIN).dial_and_serve("127.0.0.1", port))
        try:
            return await asyncio.wait_for(task, 30)
        except harness.HarnessFailure as e:
            return e.code
        finally:
            dial.cancel()

    return asyncio.run(go())


@pytest.mark.parametrize("harness_pkg,signer_pkg", PAIRS)
@pytest.mark.parametrize("case,code", [("conformant", 0), ("unsafe", 5),
                                       ("wrong_key", 2)])
def test_exit_codes_match_across_packages(harness_pkg, signer_pkg, case,
                                          code, tmp_path):
    assert run(harness_pkg, signer_pkg, case, tmp_path) == code


def test_no_signer_is_a_setup_failure():
    async def go():
        with pytest.raises(signer_harness.HarnessFailure) as ei:
            await signer_harness.run_harness(
                f"127.0.0.1:{free_port()}", CHAIN, timeout=0.5,
                log=lambda *a: None)
        return ei.value.code

    assert asyncio.run(go()) == 1


def test_the_cli_reports_its_code(tmp_path, capsys):
    """main() maps a failure to its exit code and the reference's line."""
    assert signer_harness.main(["--laddr", f"127.0.0.1:{free_port()}",
                                "--chain-id", CHAIN, "--timeout",
                                "0.5"]) == 1
    assert "FAILED (1): signer never connected" in capsys.readouterr().err
    key = tmp_path / "k.json"
    FilePV.generate(str(key), str(tmp_path / "s.json"))
    assert signer_harness._load_expected_key(str(key)) == \
        ref_harness._load_expected_key(str(key))


def test_the_cli_passes_a_cmd_signer_child(tmp_path):
    """`python -m tendermint_tpu_torch.cmd signer --connect` (always a
    SecretConnection) against the harness's CLI with
    --secret-connection and the home's key expected: exit 0."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from tendermint_tpu_torch.cmd import main as cmd_main

    root = Path(__file__).resolve().parents[1]
    home = tmp_path / "signer"
    assert cmd_main(["--home", str(home), "init", "--chain-id", CHAIN]) == 0
    port = free_port()
    child = subprocess.Popen(
        [sys.executable, "-m", "tendermint_tpu_torch.cmd", "--home",
         str(home), "signer", "--connect", f"tcp://127.0.0.1:{port}",
         "--device", "cpu"], cwd=str(root),
        env=dict(os.environ, PYTHONPATH=str(root)),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        rc = signer_harness.main([
            "--laddr", f"127.0.0.1:{port}", "--chain-id", CHAIN,
            "--expected-key", str(home / "config" /
                                  "priv_validator_key.json"),
            "--timeout", "60", "--secret-connection"])
    finally:
        child.terminate()
        child.wait(30)
    assert rc == 0
