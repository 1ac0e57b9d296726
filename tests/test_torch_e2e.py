"""The port's e2e harness (tendermint_tpu_torch/e2e/) against the JAX
package's (tendermint_tpu/e2e/).

Held on the same inputs: the sample manifest loads to the same fields;
each of the reference's validation cases (tests/test_e2e_perturb.py)
raises the same ValueError in both; the generator writes the same TOML
for seeds 0-199 and its CLI works; the admission-plane tx mix gives the
same bytes; wait_progress stalls and caps alike. Pinned in the port
alone: every child argv names only tendermint_tpu_torch modules and
carries the runner's --device; a gRPC manifest and a missing GPU are
refused before any child starts; a solo validator killed at
state.apply.app_committed heals (--device cpu, ports from the OS).
The reference's full-net cases have counterparts here marked slow, as
theirs are."""

import asyncio
import dataclasses
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tendermint_tpu import e2e as ref_e2e
from tendermint_tpu.e2e import generate as ref_generate
from tendermint_tpu.e2e import runner as ref_runner
from tendermint_tpu_torch import e2e
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.e2e import Manifest, Runner, generate, runner

ROOT = Path(__file__).resolve().parents[1]
SAMPLE = str(ROOT / "e2e" / "sample_manifest.toml")


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


def test_the_sample_manifest_loads_the_same_in_both_packages():
    port = dataclasses.asdict(Manifest.load(SAMPLE))
    ref = dataclasses.asdict(ref_e2e.Manifest.load(SAMPLE))
    assert port == ref
    assert port["nodes"] == 4 and port["wait_height"] == 10
    assert {p["op"] for p in port["perturbations"]} == {
        "kill", "pause", "disconnect", "disconnect_hard", "restart",
        "overload", "light_proxy"}


def test_manifest_keys_and_defaults_are_the_references():
    assert Manifest._KEYS == ref_e2e.Manifest._KEYS
    assert Manifest._PERTURB_KEYS == ref_e2e.Manifest._PERTURB_KEYS
    assert dataclasses.asdict(Manifest()) == \
        dataclasses.asdict(ref_e2e.Manifest())
    assert e2e.manifest.OPS == ref_e2e.manifest.OPS


SP = {"node": 0, "op": "statesync_poison", "at_height": 2}
# the inputs of the reference's validation tests
# (tests/test_e2e_perturb.py:14,46,208,270,317), and more of
# Manifest.validate's branches
INVALID = [
    {"nodes": 2, "perturbations": [
        {"node": 5, "op": "kill", "at_height": 1}]},
    {"perturbations": [{"node": 0, "op": "nuke", "at_height": 1}]},
    {"nodes": 4, "perturbations": [SP]},
    {"nodes": 4, "late_statesync_node": True,
     "perturbations": [dict(SP, node=3)]},
    {"nodes": 2, "wait_height": 4, "validator_updates": [
        {"node": 0, "at_height": 2, "power": 5}]},
    {"nodes": 2, "wait_height": 9, "validator_updates": [
        {"node": 0, "at_height": 2, "power": 5, "bogus": 1}]},
    {"nodes": 2, "abci": "udp"},
    {"nodes": 2, "wait_height": 9, "abci": "tcp", "validator_updates": [
        {"node": 0, "at_height": 2, "power": 5}]},
    {"nodes": 2, "privval": "unix2"},
    {"nodes": 2, "privval": "tcp", "misbehaviors": [
        {"node": 0, "spec": "double-prevote@2"}]},
    {"nodes": 0},
    {"nodes": 3, "late_statesync_node": True},
    {"nodes": 4, "wait_height": 0},
    {"bogus_key": 1},
    {"perturbations": [{"node": 0, "op": "kill", "at_height": 0}]},
    {"perturbations": [{"node": 0, "op": "kill", "at_height": 2,
                        "failpoint": "no.such.point"}]},
    {"perturbations": [{"node": 0, "op": "disconnect_hard",
                        "at_height": 2, "duration": 61}]},
    {"perturbations": [{"node": 0, "op": "chaos", "at_height": 2,
                        "failpoint": "wal.fsync", "action": "crash"}]},
    {"perturbations": [{"node": 0, "op": "spec_mismatch",
                        "at_height": 1}]},
    {"perturbations": [{"node": 0, "op": "light_proxy",
                        "at_height": 3}]},
    {"perturbations": [{"node": 0, "op": "overload", "at_height": 2,
                        "action": "corrupt"}]},
    {"perturbations": [{"node": 0, "op": "overload", "at_height": 2,
                        "tx_signed": 0.6, "tx_garbage": 0.6}]},
    {"misbehaviors": [{"node": 0, "spec": "double-vote"}]},
    {"nodes": 4, "wait_height": 9, "late_statesync_node": True,
     "validator_updates": [{"node": 0, "at_height": 2, "power": 0},
                           {"node": 1, "at_height": 3, "power": 0}]},
]
VALID = [
    {"nodes": 3, "wait_height": 5, "load_tx_rate": 2.0,
     "perturbations": [{"node": 1, "op": "kill", "at_height": 2},
                       {"node": 2, "op": "pause", "at_height": 3,
                        "duration": 1.5}]},
    {"nodes": 4, "late_statesync_node": True, "perturbations": [SP]},
    {"nodes": 4, "wait_height": 9, "validator_updates": [
        {"node": 3, "at_height": 2, "power": 3}]},
    {"nodes": 2, "abci": "grpc"},
]


@pytest.mark.parametrize("d", INVALID, ids=range(len(INVALID)))
def test_validation_raises_the_same_error(d):
    with pytest.raises(ValueError) as ref_err:
        ref_e2e.Manifest.from_dict(d)
    with pytest.raises(ValueError) as port_err:
        Manifest.from_dict(d)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("d", VALID, ids=range(len(VALID)))
def test_valid_manifests_parse_the_same(d):
    assert dataclasses.asdict(Manifest.from_dict(d)) == \
        dataclasses.asdict(ref_e2e.Manifest.from_dict(d))


def test_the_generator_writes_the_references_text_for_200_seeds():
    for seed in range(200):
        port = generate.to_toml(generate.generate(random.Random(seed), seed))
        ref = ref_generate.to_toml(
            ref_generate.generate(random.Random(seed), seed))
        assert port == ref, f"seed {seed}"
    ms = [generate.generate(random.Random(s)) for s in range(200)]
    assert {m.abci for m in ms} == {"builtin", "tcp", "grpc"}
    assert {m.privval for m in ms} == {"file", "tcp"}


def test_generator_toml_round_trip(tmp_path):
    m = generate.generate(random.Random(7), 7)
    p = tmp_path / "m.toml"
    p.write_text(generate.to_toml(m))
    assert generate.to_toml(Manifest.load(str(p))) == generate.to_toml(m)


def test_the_generate_cli(tmp_path, capsys):
    out = tmp_path / "m.toml"
    assert generate.main(["--seed", "3", "--out", str(out)]) == 0
    assert Manifest.load(str(out)).generator_seed == 3
    assert generate.main(["--seed", "3"]) == 0
    text = capsys.readouterr().out
    assert text == out.read_text()
    assert ref_generate.main(["--seed", "3"]) == 0
    assert capsys.readouterr().out == text
    res = subprocess.run(
        [sys.executable, "-m", "tendermint_tpu_torch.e2e.generate",
         "--seed", "3"], cwd=str(ROOT), capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert res.returncode == 0 and res.stdout == text


def test_envelope_mix_tx_gives_the_references_bytes():
    from tendermint_tpu.crypto.ed25519 import Ed25519PrivKey as RefKey
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PrivKey

    key = Ed25519PrivKey.from_secret(b"e2e-flood-signer")
    ref_key = RefKey.from_secret(b"e2e-flood-signer")
    kinds = set()
    for i in range(200):
        payload = b"flood-%d" % i
        got = runner.envelope_mix_tx(i, payload, key, 0.1, 0.3)
        want = ref_runner.envelope_mix_tx(i, payload, ref_key, 0.1, 0.3)
        assert got == want, i
        kinds.add("raw" if got == payload else "envelope")
    assert kinds == {"raw", "envelope"}


def _wait(mod, sample, done, **kw):
    try:
        return "done", asyncio.run(mod.wait_progress(sample, done, **kw))
    except TimeoutError as e:
        return "timeout", str(e)


def test_wait_progress_stalls_and_caps_as_the_reference():
    def stuck():
        async def sample():
            return 7
        return sample

    def moving():
        n = [0]

        async def sample():
            n[0] += 1
            return n[0]
        return sample

    for mod in (runner, ref_runner):
        kind, msg = _wait(mod, stuck(), lambda s: False, timeout=10,
                          stall_timeout=0.6, what="x")
        assert kind == "timeout"
        assert msg == "stalled at 7 waiting for x for 1s"
        kind, msg = _wait(mod, moving(), lambda s: False, timeout=0.3,
                          stall_timeout=5, cap_factor=2, what="y")
        assert kind == "timeout"
        assert msg.startswith("y not reached within 1s (at ")
        assert _wait(mod, moving(), lambda s: s >= 3, timeout=5,
                     what="z") == ("done", 3)


def _children(r: Runner):
    procs = list(r.nodes) + list(r.signers) + list(r.apps)
    if r.seed is not None:
        procs.append(r.seed)
    return procs


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_every_child_argv_is_the_ports_and_carries_the_device(tmp_path,
                                                              device):
    combos = [
        {"nodes": 3, "abci": "tcp", "privval": "tcp",
         "seed_bootstrap": True},
        {"nodes": 4, "misbehaviors": [
            {"node": 2, "spec": "double-prevote@4"}]},
    ]
    seen = set()
    for k, d in enumerate(combos):
        r = Runner(Manifest.from_dict(d), str(tmp_path / f"net{k}"),
                   base_port=0, log=lambda s: None, device=device)
        r.setup()
        for proc in _children(r):
            argv = proc.argv()
            seen.add(type(proc).__name__)
            mods = [argv[i + 1] for i, a in enumerate(argv) if a == "-m"]
            assert mods and all(
                m.startswith("tendermint_tpu_torch.") for m in mods), argv
            assert not any(a.startswith("tendermint_tpu.") for a in argv)
            if not isinstance(proc, runner.AppProc):
                assert argv[argv.index("--device") + 1] == device
    assert seen == {"NodeProc", "SignerProc", "AppProc"}


def test_the_runner_lays_out_the_references_ports_from_its_own_base(
        tmp_path):
    r = Runner(Manifest.from_dict({"nodes": 2}), str(tmp_path / "net"),
               log=lambda s: None, device="cpu")
    assert r.base_port == runner.BASE_PORT != ref_runner.BASE_PORT
    r.setup()
    from tendermint_tpu_torch.config import Config

    cfg = Config.load(str(tmp_path / "net" / "node1" / "config"
                          / "config.toml"))
    assert cfg.p2p.laddr == f"tcp://127.0.0.1:{runner.BASE_PORT + 1}"
    assert cfg.rpc.laddr == f"tcp://127.0.0.1:{runner.BASE_PORT + 1001}"
    assert cfg.p2p.persistent_peers.endswith(f":{runner.BASE_PORT}")
    assert r.nodes[1].rpc_port == runner.BASE_PORT + 1001


def test_a_grpc_manifest_is_refused_before_any_child(tmp_path,
                                                     monkeypatch):
    m = Manifest.from_dict({"nodes": 2, "abci": "grpc"})
    started = []
    monkeypatch.setattr(runner.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    r = Runner(m, str(tmp_path / "net"), base_port=0, log=lambda s: None,
               device="cpu")
    with pytest.raises(NotImplementedError, match="gRPC"):
        asyncio.run(r.run())
    assert started == [] and not (tmp_path / "net").exists()


def test_no_gpu_and_no_cpu_flag_exits_1_before_any_child(tmp_path):
    out = tmp_path / "net"
    res = subprocess.run(
        [sys.executable, "-m", "tendermint_tpu_torch.e2e.runner", SAMPLE,
         "--out", str(out)], cwd=str(ROOT), capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 1, res.stdout + res.stderr
    assert "NoDeviceError" in res.stderr
    assert not out.exists()


def test_a_solo_validator_heals_from_a_kill_at_a_commit_point(tmp_path):
    """One validator, killed by a crash armed at
    state.apply.app_committed at height 3, restarted, at wait_height 5:
    the report carries the reference runner's keys and a healed
    kill_recoveries entry. Every port from the OS."""
    m = Manifest.from_dict({
        "chain_id": "solo-chain", "nodes": 1, "wait_height": 5,
        "timeout_commit_ms": 100,
        "perturbations": [{"node": 0, "op": "kill", "at_height": 3,
                           "failpoint": "state.apply.app_committed"}]})
    logs = []
    r = Runner(m, str(tmp_path / "net"), base_port=0, log=logs.append,
               device="cpu")
    t0 = time.monotonic()
    report = asyncio.run(asyncio.wait_for(r.run(), timeout=50))
    assert time.monotonic() - t0 < 50
    assert {"ok", "height", "nodes", "evidence_committed", "min_peers",
            "txs_sent", "valset_changes", "kill_recoveries"} <= set(report)
    assert report["ok"] and report["height"] == 5 and report["nodes"] == 1
    (kr,) = report["kill_recoveries"]
    assert kr["failpoint"] == "state.apply.app_committed"
    assert kr["crashed_at_point"] and kr["recovered"]
    assert kr["recovered_height"] > kr["height_at_kill"] >= 3
    node_log = (tmp_path / "net" / "node0" / "node.log").read_bytes()
    assert node_log.count(b"node node0 started") >= 2
    assert not r.nodes[0].alive()


# -- the reference's full-net cases (tests/test_e2e_perturb.py:66-469,
# tests/test_e2e_generate.py:71), slow as theirs are; on the CPU with
# every port from the OS

def _run(m, tmp_path, logs=None):
    r = Runner(m, str(tmp_path / "net"), base_port=0,
               log=(logs.append if logs is not None else lambda s: None),
               device="cpu")
    return r, asyncio.run(asyncio.wait_for(r.run(), timeout=3000))


@pytest.mark.slow
def test_perturbations_full_run(tmp_path):
    m = Manifest.from_dict({
        "chain_id": "perturb-chain", "nodes": 4, "wait_height": 6,
        "load_tx_rate": 4.0, "timeout_commit_ms": 150,
        "perturbations": [
            {"node": 1, "op": "kill", "at_height": 2},
            {"node": 2, "op": "pause", "at_height": 3, "duration": 2.0},
            {"node": 3, "op": "disconnect", "at_height": 4,
             "duration": 4.0},
            {"node": 0, "op": "restart", "at_height": 5}]})
    logs = []
    _, report = _run(m, tmp_path, logs)
    assert report["ok"] and report["nodes"] == 4 and report["txs_sent"] > 0
    assert len([ln for ln in logs if ln.startswith("perturb:")]) == 4
    n1_log = (tmp_path / "net" / "node1" / "node.log").read_bytes()
    assert n1_log.count(b"node node1 started") >= 2


@pytest.mark.slow
def test_maverick_evidence_is_committed(tmp_path):
    m = Manifest.from_dict({
        "chain_id": "maverick-chain", "nodes": 4, "wait_height": 8,
        "timeout_commit_ms": 150,
        "misbehaviors": [{"node": 3, "spec": "double-prevote@3"}]})
    _, report = _run(m, tmp_path)
    assert report["ok"] and report["evidence_committed"] >= 1


@pytest.mark.slow
def test_late_statesync_node_joins(tmp_path):
    m = Manifest.from_dict({
        "chain_id": "ss-chain", "nodes": 4, "wait_height": 10,
        "timeout_commit_ms": 150, "late_statesync_node": True})
    logs = []
    _, report = _run(m, tmp_path, logs)
    assert report["ok"] and report["nodes"] == 4
    assert any("late statesync node3" in ln for ln in logs)
    assert b"state sync done at height" in (
        tmp_path / "net" / "node3" / "node.log").read_bytes()


@pytest.mark.slow
def test_validator_update_schedule(tmp_path):
    m = Manifest.from_dict({
        "chain_id": "valupd-chain", "nodes": 4, "wait_height": 8,
        "load_tx_rate": 2.0, "timeout_commit_ms": 150,
        "validator_updates": [{"node": 3, "at_height": 2, "power": 3}]})
    logs = []
    _, report = _run(m, tmp_path, logs)
    assert report["ok"] and report["valset_changes"] == 1
    assert any(ln.startswith("valupdate:") for ln in logs)


@pytest.mark.slow
def test_out_of_process_abci_tcp(tmp_path):
    m = Manifest.from_dict({
        "chain_id": "abci-tcp-chain", "nodes": 3, "wait_height": 6,
        "load_tx_rate": 2.0, "timeout_commit_ms": 150, "abci": "tcp",
        "perturbations": [{"node": 1, "op": "kill", "at_height": 3}]})
    _, report = _run(m, tmp_path)
    assert report["ok"] and report["nodes"] == 3
    for i in range(3):
        assert "serving KVStoreApp abci=socket" in (
            tmp_path / "net" / f"node{i}" / "app.log").read_text()


@pytest.mark.slow
def test_remote_signer_privval_net(tmp_path):
    m = Manifest.from_dict({
        "chain_id": "privval-chain", "nodes": 3, "wait_height": 6,
        "load_tx_rate": 2.0, "timeout_commit_ms": 150, "privval": "tcp",
        "perturbations": [{"node": 1, "op": "restart", "at_height": 3}]})
    _, report = _run(m, tmp_path)
    assert report["ok"] and report["nodes"] == 3
    net = tmp_path / "net"
    for i in range(3):
        assert not (net / f"node{i}" / "config"
                    / "priv_validator_key.json").exists()
        assert "connected to validator" in (
            net / f"signer{i}" / "signer.log").read_text()
    assert (net / "signer1" / "signer.log").read_text().count(
        "connected to validator") >= 2


@pytest.mark.slow
def test_seed_bootstrap_net(tmp_path):
    m = Manifest.from_dict({
        "chain_id": "seed-chain", "nodes": 4, "wait_height": 5,
        "timeout_commit_ms": 150, "seed_bootstrap": True})
    r, report = _run(m, tmp_path)
    assert report["ok"] and report["min_peers"] >= 2, report
    for i in range(4):
        cfg = (tmp_path / "net" / f"node{i}" / "config"
               / "config.toml").read_text()
        assert 'persistent_peers = ""' in cfg
        assert f"@127.0.0.1:{r.port('seed_p2p')}" in cfg


@pytest.mark.slow
def test_combined_matrix_dimensions(tmp_path):
    m = Manifest.from_dict({
        "chain_id": "combo-chain", "nodes": 4, "wait_height": 6,
        "load_tx_rate": 2.0, "timeout_commit_ms": 150, "abci": "tcp",
        "privval": "tcp", "seed_bootstrap": True,
        "perturbations": [
            {"node": 1, "op": "kill", "at_height": 3},
            {"node": 2, "op": "pause", "at_height": 4, "duration": 2.0}]})
    _, report = _run(m, tmp_path)
    assert report["ok"] and report["min_peers"] >= 1
    net = tmp_path / "net"
    assert (net / "signer1" / "signer.log").read_text().count(
        "connected to validator") >= 2


@pytest.mark.slow
def test_spec_mismatch_perturbation(tmp_path):
    m = Manifest.from_dict({
        "chain_id": "specmm-chain", "nodes": 4, "wait_height": 7,
        "timeout_commit_ms": 150,
        "perturbations": [{"node": 1, "op": "spec_mismatch",
                           "at_height": 3, "duration": 3.0}]})
    r, report = _run(m, tmp_path)
    assert report["ok"]
    (srep,) = r.spec_mismatch_reports
    assert srep["hits_delta"] == 0 and srep["misses_delta"] > 0


@pytest.mark.slow
def test_overload_perturbation(tmp_path):
    m = Manifest.from_dict({
        "chain_id": "overload-chain", "nodes": 4, "wait_height": 7,
        "load_tx_rate": 2.0, "timeout_commit_ms": 150,
        "perturbations": [
            {"node": 1, "op": "overload", "at_height": 3, "duration": 6.0,
             "failpoint": "device.verify", "action": "delay",
             "delay_ms": 25, "tx_rate": 150}]})
    r, report = _run(m, tmp_path)
    assert report["ok"]
    (orep,) = r.overload_reports
    hs = [h for h in orep["heights"] if h]
    assert hs and all(b >= a for a, b in zip(hs, hs[1:])) and hs[-1] > hs[0]
    assert orep["shed_delta"] > 0 and orep["bounded"] and orep["cleared"]


@pytest.mark.slow
def test_disconnect_hard_severs_and_reconnects(tmp_path):
    m = Manifest.from_dict({
        "chain_id": "sever-chain", "nodes": 4, "wait_height": 7,
        "load_tx_rate": 2.0, "timeout_commit_ms": 150,
        "perturbations": [{"node": 1, "op": "disconnect_hard",
                           "at_height": 3, "duration": 3.0}]})
    logs = []
    _, report = _run(m, tmp_path, logs)
    assert report["ok"]
    drops = [ln for ln in logs if "dropped" in ln and "conns" in ln]
    assert drops and int(drops[0].split("dropped")[1].split("conns")[0]) >= 1


@pytest.mark.slow
def test_the_sample_manifest_full_run(tmp_path):
    _, report = _run(Manifest.load(SAMPLE), tmp_path)
    assert report["ok"] and report["evidence_committed"] >= 1
    assert all(k["recovered"] for k in report["kill_recoveries"])
    assert report["light_proxy"][0]["verify_launches"] < 12


@pytest.mark.slow
@pytest.mark.parametrize("seed", [101, 202])
def test_random_manifest_full_run(tmp_path, seed):
    m = generate.generate(random.Random(seed), seed)
    if m.abci == "grpc":  # refused at run: not ported
        with pytest.raises(NotImplementedError):
            _run(m, tmp_path)
        return
    _, report = _run(m, tmp_path)
    assert report["ok"] and report["generator_seed"] == seed
