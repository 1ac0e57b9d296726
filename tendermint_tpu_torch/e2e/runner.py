"""e2e runner: testnet subprocesses + tx load + perturbations + checks
(reference: tendermint_tpu/e2e/runner.py, stage for stage; Go
test/e2e/runner/{main,setup,start,load,perturb}.go).

Stages, mirroring the reference runner:
  setup    -> `testnet` CLI generates N mesh-wired home dirs
  start    -> one `python -m tendermint_tpu_torch.cmd start` subprocess
              per node, on the runner's device
  load     -> background broadcast_tx_async stream (load.go:18)
  perturb  -> at scheduled heights: kill -9 (+restart with WAL
              recovery), SIGSTOP pause, long-SIGSTOP "disconnect"
              (peers drop the frozen node; it must re-dial on wake),
              graceful restart (perturb.go:12-60), and "chaos" —
              arming a named failpoint (libs/failpoints.py) on a
              node via POST /debug/failpoint for a window
  test     -> every node reaches wait_height; all block hashes agree
              (no fork); perturbed nodes caught back up
  cleanup  -> SIGTERM all, SIGKILL stragglers

CLI: python -m tendermint_tpu_torch.e2e.runner <manifest.toml> [--out DIR]
        [--device {cuda,cpu}]

The device rule: every node, signer and seed child gets `--device`
(default cuda, the card), and the `light_proxy` perturbation's
in-process serving plane runs on the same device. Without a GPU and
without `--device cpu` the runner raises NoDeviceError (the CLI exits
1 naming it) before it starts any child. Where the reference forces
JAX_PLATFORMS=cpu on its children, the port's children run where the
runner says. A manifest with abci = "grpc" validates as in the reference but
raises NotImplementedError at run, before any child: the gRPC ABCI
transport is not ported.

Ports: `base_port` lays them out as the reference does (p2p base+i,
RPC base+1000+i, app base+2000+i, signer base+3000+i, debug
base+4000+i, the seed's base+500 and base+1500), from BASE_PORT by
default, apart from the reference's 27100; base_port=0 takes every
port from the OS instead (a bind to port 0).
"""

from __future__ import annotations

import asyncio
import os
import shutil
import signal
import socket
import subprocess
import sys
import time

from .manifest import Manifest, Perturbation

BASE_PORT = 37100
# each port's offset from base_port (the reference's layout)
PORT_OFFSETS = {"p2p": 0, "rpc": 1000, "app": 2000, "pv": 3000,
                "pprof": 4000, "seed_p2p": 500, "seed_rpc": 1500}
PKG = "tendermint_tpu_torch"


async def wait_progress(sample, done, *, timeout: float = 120.0,
                        stall_timeout: float | None = None,
                        cap_factor: float = 4.0, what: str = "target"):
    """Progress-gated wait: `sample()` (async) takes a snapshot of
    arbitrary progress state; `done(snapshot)` says when to stop.
    Fails on a STALL (snapshot unchanged for stall_timeout) or the
    absolute cap (cap_factor * timeout) — never on a fixed deadline a
    loaded single-core CI box can blow while the system is healthy.
    The single implementation behind every e2e/net wait; returns the
    final snapshot."""
    stall_timeout = stall_timeout or max(60.0, timeout / 2)
    start = last_change = time.monotonic()
    last = object()
    while True:
        snap = await sample()
        if done(snap):
            return snap
        now = time.monotonic()
        if snap != last:
            last, last_change = snap, now
        if now - last_change > stall_timeout:
            raise TimeoutError(
                f"stalled at {snap!r} waiting for {what} "
                f"for {stall_timeout:.0f}s")
        if now - start > cap_factor * timeout:
            raise TimeoutError(
                f"{what} not reached within {cap_factor * timeout:.0f}s "
                f"(at {snap!r})")
        await asyncio.sleep(0.25)


def envelope_mix_tx(i: int, payload: bytes, signer,
                    signed_frac: float, garbage_frac: float) -> bytes:
    """Deterministic signed/garbage/raw admission-plane mix: tx `i`
    becomes a structurally valid envelope with a hopeless signature
    (must die at admission, never reach the app) when
    ``i%100 < garbage_frac*100``, a validly signed envelope below
    ``(garbage_frac+signed_frac)*100``, and the raw payload otherwise.
    One builder shared by `tx_flood` and the reference's
    tools/mempool_bench.py --admission, so the flood and the bench can
    never diverge on what the mix fractions mean."""
    from ..types import tx_envelope

    slot = i % 100
    if slot < garbage_frac * 100:
        return tx_envelope.encode(signer.pub_key().bytes(), bytes(64),
                                  payload)
    if slot < (garbage_frac + signed_frac) * 100:
        return tx_envelope.sign_tx(signer, payload)
    return payload


async def tx_flood(submit, rate: float, duration: float,
                   prefix: bytes = b"flood",
                   max_outstanding: int = 256,
                   signed_frac: float = 0.0,
                   garbage_frac: float = 0.0,
                   signer=None) -> int:
    """Paced unique-tx flood: fire `submit(tx_bytes)` at `rate` txs/s
    for `duration` seconds, swallowing per-tx errors (429 sheds and
    perturbed nodes are the POINT of the exercise). Pacing is against
    an ABSOLUTE deadline with fire-and-forget submissions (bounded
    in-flight) — awaiting each submit inline would let the target's
    own slowness throttle the flood below the rate it is supposed to
    overrun, defeating the overload scenario exactly when it bites.
    Returns the number of submissions attempted. Shared by the e2e
    `overload` perturbation (submit = RPC broadcast) and the reference's
    tools/net_stress.py --overload (in-process funnel injection).

    `signed_frac` / `garbage_frac` mix in txs wrapped in
    types/tx_envelope.py envelopes — validly signed and
    garbage-signature respectively — so a flood exercises the mempool
    admission plane's shed path, deterministically interleaved (tx i
    is garbage when i%100 < garbage*100, signed when below
    (garbage+signed)*100, raw otherwise)."""
    start = time.monotonic()
    sent = 0
    tasks: set = set()
    if signed_frac or garbage_frac:
        from ..crypto.ed25519 import Ed25519PrivKey

        signer = signer or Ed25519PrivKey.from_secret(b"e2e-flood-signer")

    def make_tx(i: int) -> bytes:
        payload = b"%s-%d-%d" % (prefix, id(submit) & 0xFFFF, i)
        if signed_frac or garbage_frac:
            return envelope_mix_tx(i, payload, signer,
                                   signed_frac, garbage_frac)
        return payload

    async def one(tx: bytes) -> None:
        try:
            await submit(tx)
        except Exception:
            pass

    loop = asyncio.get_running_loop()
    while True:
        now = time.monotonic()
        if now >= start + duration:
            break
        behind = int((now - start) * rate) + 1 - sent
        for _ in range(max(behind, 0)):
            t = loop.create_task(one(make_tx(sent)))
            tasks.add(t)
            t.add_done_callback(tasks.discard)
            sent += 1
            if len(tasks) >= max_outstanding:
                await asyncio.wait(tasks,
                                   return_when=asyncio.FIRST_COMPLETED)
        await asyncio.sleep(min(1.0 / rate, 0.05))
    if tasks:
        await asyncio.wait(tasks, timeout=10.0)
    return sent


def _child_env() -> dict:
    """Env for e2e child processes: this checkout first on PYTHONPATH.
    The device is not an environment variable here: each child is
    given the runner's `--device`."""
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def free_port() -> int:
    """A port the OS reports free on 127.0.0.1 (a bind to port 0)."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _terminate_proc(proc: subprocess.Popen | None, log_f,
                    timeout: float = 30.0):
    """SIGTERM -> wait -> SIGKILL, then close the log fd. Returns the
    (now closed) log handle slot value (always None) for assignment."""
    if proc is not None and proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    if log_f is not None:
        log_f.close()
    return None


class AppProc:
    """An out-of-process ABCI app server (abci = "tcp" | "grpc"):
    one kvstore server per node, so node perturbations exercise the
    handshake replay against a live external app — the reference e2e
    matrix's ABCIProtocol dimension."""

    def __init__(self, index: int, home: str, port: int, abci: str):
        self.index = index
        self.port = port
        self.abci = abci  # "socket" | "grpc" (abci-cli values)
        self.log_path = os.path.join(home, "app.log")
        self.proc: subprocess.Popen | None = None
        self._log_f = None

    def start(self) -> None:
        self._log_f = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            self.argv(), stdout=self._log_f, stderr=subprocess.STDOUT,
            env=_child_env())

    def argv(self) -> list[str]:
        """The app server runs no kernel: it takes no --device."""
        return [sys.executable, "-m", f"{PKG}.abci.cli", "kvstore",
                "--address", f"tcp://127.0.0.1:{self.port}",
                "--abci", self.abci]

    def terminate(self) -> None:
        self._log_f = _terminate_proc(self.proc, self._log_f,
                                      timeout=10.0)


class SignerProc:
    """A remote-signer sidecar process (privval = "tcp"): holds the
    validator key OUT of the node home and dials the node's
    priv_validator_laddr over SecretConnection — the reference e2e
    matrix's PrivvalProtocol dimension."""

    def __init__(self, index: int, home: str, connect: str,
                 device: str = "cuda"):
        self.index = index
        self.home = home
        self.connect = connect
        self.device = device
        self.log_path = os.path.join(home, "signer.log")
        self.proc: subprocess.Popen | None = None
        self._log_f = None

    def start(self) -> None:
        self._log_f = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            self.argv(),
            stdout=self._log_f, stderr=subprocess.STDOUT,
            env=_child_env())

    def argv(self) -> list[str]:
        return [sys.executable, "-m", f"{PKG}.cmd", "--home", self.home,
                "signer", "--connect", self.connect,
                "--device", self.device]

    def terminate(self) -> None:
        self._log_f = _terminate_proc(self.proc, self._log_f,
                                      timeout=10.0)


class NodeProc:
    def __init__(self, index: int, home: str, rpc_port: int,
                 misbehavior: str = "", pprof_port: int = 0,
                 device: str = "cuda"):
        self.index = index
        self.home = home
        self.rpc_port = rpc_port
        self.misbehavior = misbehavior
        self.pprof_port = pprof_port  # chaos/debug endpoint (0 = off)
        self.device = device  # the node's --device
        self.proc: subprocess.Popen | None = None
        self.log_path = os.path.join(home, "node.log")
        self._log_f = None

    def start(self, extra_env: dict | None = None) -> None:
        """extra_env applies to THIS boot only (the failpoint sweep
        injects FAIL_TEST_INDEX for the crashing boot, restarts clean)."""
        assert self.proc is None or self.proc.poll() is not None
        env = _child_env()
        env.update(extra_env or {})
        cmd = self.argv()
        if self.misbehavior:
            env["TM_TPU_ENABLE_MAVERICK"] = "1"  # e2e test net only
        if self._log_f is not None:
            self._log_f.close()  # one fd per node, not per restart
        self._log_f = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            cmd,
            stdout=self._log_f,
            stderr=subprocess.STDOUT, env=env)

    def argv(self) -> list[str]:
        cmd = [sys.executable, "-m", f"{PKG}.cmd", "--home", self.home,
               "start", "--device", self.device]
        if os.environ.get("TM_E2E_DEBUG"):
            cmd += ["--log_level", "debug"]
        if self.misbehavior:
            cmd += ["--misbehavior", self.misbehavior]
        return cmd

    @property
    def pid(self) -> int:
        assert self.proc is not None
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill9(self) -> None:
        if self.alive():
            os.kill(self.pid, signal.SIGKILL)
            self.proc.wait()

    def sigstop(self) -> None:
        os.kill(self.pid, signal.SIGSTOP)

    def sigcont(self) -> None:
        os.kill(self.pid, signal.SIGCONT)

    def terminate(self, timeout: float = 10.0) -> None:
        self._log_f = _terminate_proc(self.proc, self._log_f,
                                      timeout=timeout)


class Runner:
    def __init__(self, manifest: Manifest, out_dir: str,
                 base_port: int = BASE_PORT, log=print,
                 device: str = "cuda"):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, not {device!r}")
        self.m = manifest
        self.out_dir = out_dir
        self.base_port = base_port
        self.device = device  # every child's --device, and the light plane's
        self._ports: dict[tuple[str, int], int] = {}
        self.nodes: list[NodeProc] = []
        self.log = log
        self._load_task = None
        self._txs_sent = 0
        self._expected_powers: dict[str, int] = {}
        self._valset_changes = 0
        self.apps: list[AppProc] = []
        self.signers: list[SignerProc] = []
        self.seed: NodeProc | None = None
        # one report dict per applied `overload` perturbation —
        # heights/levels/shed deltas for the liveness assertions
        self.overload_reports: list[dict] = []
        # one report dict per kill perturbation with a `failpoint` —
        # did the armed crash fire, and did handshake recovery bring
        # the node back past its kill height
        self.kill_reports: list[dict] = []
        # one report dict per `light_proxy` perturbation — coalescing
        # ratio, parity with the primary, sheds under flood
        self.light_proxy_reports: list[dict] = []
        # one report dict per `spec_mismatch` perturbation — hit/miss
        # deltas under the wrong-timestamp flood + liveness through it
        self.spec_mismatch_reports: list[dict] = []
        # `statesync_poison` perturbations stay armed through the late
        # joiner's restore; checked + disarmed after wait_height
        self._statesync_poisons: list = []
        self.statesync_poison_reports: list[dict] = []
        # the nodes whose /debug/launches answered collect_launch_ledger
        # (a node with an empty ledger answers but has no report entry)
        self.ledger_answered: list[str] = []

    def port(self, kind: str, i: int = 0) -> int:
        """The port of `kind` (PORT_OFFSETS) for node i: the reference's
        layout from base_port, or one from the OS when base_port is 0."""
        if self.base_port:
            return self.base_port + PORT_OFFSETS[kind] + i
        key = (kind, i)
        if key not in self._ports:
            taken = set(self._ports.values())
            p = free_port()
            while p in taken:
                p = free_port()
            self._ports[key] = p
        return self._ports[key]

    def check_runnable(self) -> None:
        """What the port refuses before any child starts: a gRPC ABCI
        manifest (not ported), and the card when there is none."""
        from .. import device as _device

        if self.m.abci == "grpc":
            raise NotImplementedError(
                'abci = "grpc": the gRPC ABCI transport is not ported;'
                ' use "builtin" or "tcp"')
        if self.device == "cpu":
            _device.set_default_device("cpu")
        else:
            _device.default_device()  # NoDeviceError without a GPU

    # -- stages --

    def setup(self) -> None:
        from ..cmd import main as cli_main
        from ..p2p.key import NodeKey

        if os.path.exists(self.out_dir):
            shutil.rmtree(self.out_dir)
        rc = cli_main([
            "testnet", "--v", str(self.m.nodes), "--o", self.out_dir,
            "--chain-id", self.m.chain_id or "e2e-chain",
            "--starting-port", str(self.base_port or BASE_PORT),
        ])
        assert rc == 0, "testnet generation failed"
        # the mesh on the runner's ports (the same as testnet's when
        # base_port is set; from the OS when it is 0)
        node_ids = [NodeKey.load_or_gen(os.path.join(
            self.out_dir, f"node{j}", "config", "node_key.json")).id
            for j in range(self.m.nodes)]
        seed_str = self._make_seed_home() if self.m.seed_bootstrap \
            else None
        for i in range(self.m.nodes):
            home = os.path.join(self.out_dir, f"node{i}")
            cfg_path = os.path.join(home, "config", "config.toml")
            from ..config import Config

            cfg = Config.load(cfg_path)
            cfg.base.home = home
            cfg.p2p.laddr = f"tcp://127.0.0.1:{self.port('p2p', i)}"
            cfg.rpc.laddr = f"tcp://127.0.0.1:{self.port('rpc', i)}"
            cfg.p2p.persistent_peers = ",".join(
                f"{node_ids[j]}@127.0.0.1:{self.port('p2p', j)}"
                for j in range(self.m.nodes) if j != i)
            # fast_sync ON (reference default): a node restarted after
            # kill -9 far behind the tip block-syncs the gap — pure
            # consensus catch-up gossip cannot outrun the net's commit
            # rate on longer gaps. At genesis everyone is at height 0,
            # so the pool reports caught-up and switches to consensus
            # immediately.
            cfg.base.fast_sync = True
            # distinct monikers: they label each node's trace spans +
            # origin tags (height forensics), and "node" x N is useless
            cfg.base.moniker = f"node{i}"
            cfg.consensus.timeout_commit_ms = self.m.timeout_commit_ms
            # Test-speed PEX cadence for EVERY e2e node (the request
            # rate limits scale with it, p2p/pex/reactor.py): a
            # severed/killed node must rediscover peers within a test
            # run, not on the 30 s production cadence.
            cfg.p2p.pex_ensure_period_s = 2.0
            if any(p.op == "disconnect_hard"
                   for p in self.m.perturbations):
                cfg.rpc.unsafe = True  # exposes unsafe_net_sever
            pprof_port = 0
            if any(p.op in ("chaos", "overload", "spec_mismatch",
                            "statesync_poison")
                   or (p.op == "kill" and p.failpoint)
                   for p in self.m.perturbations):
                # chaos/overload perturbations drive the node's debug
                # endpoint (POST /debug/failpoint, GET /status,
                # GET /metrics) — give every node one
                pprof_port = self.port("pprof", i)
                cfg.rpc.pprof_laddr = f"tcp://127.0.0.1:{pprof_port}"
            if any(p.op == "overload" and p.node == i
                   for p in self.m.perturbations):
                # Test-scale RPC budget for the flood target (like the
                # test-speed PEX cadence above): the tx flood must be
                # able to overrun the token bucket within a
                # seconds-long window so shedding is OBSERVABLE — the
                # debug endpoint (pprof port) is not rate limited, so
                # the runner's own sampling still gets through.
                cfg.rpc.rate_limit_rps = 50.0
            if seed_str is not None:
                # the ONLY configured contact is the seed: the mesh
                # must form via PEX address-book discovery (fast
                # cadence set above for every node)
                cfg.p2p.persistent_peers = ""
                cfg.p2p.seeds = seed_str
            if self.m.abci != "builtin":
                app_port = self.port("app", i)
                cfg.base.proxy_app = f"127.0.0.1:{app_port}"
                cfg.base.abci = ("grpc" if self.m.abci == "grpc"
                                 else "socket")
                self.apps.append(AppProc(
                    i, home, app_port,
                    "grpc" if self.m.abci == "grpc" else "socket"))
            if self.m.privval == "tcp":
                # move the validator key OUT of the node home into a
                # signer-sidecar home; the node listens for the signer
                signer_home = os.path.join(self.out_dir, f"signer{i}")
                os.makedirs(os.path.join(signer_home, "config"))
                os.makedirs(os.path.join(signer_home, "data"))
                os.replace(
                    os.path.join(home, "config",
                                 "priv_validator_key.json"),
                    os.path.join(signer_home, "config",
                                 "priv_validator_key.json"))
                shutil.copy(
                    os.path.join(home, "config", "genesis.json"),
                    os.path.join(signer_home, "config",
                                 "genesis.json"))
                pv_port = self.port("pv", i)
                cfg.base.priv_validator_laddr = \
                    f"tcp://127.0.0.1:{pv_port}"
                self.signers.append(SignerProc(
                    i, signer_home, f"tcp://127.0.0.1:{pv_port}",
                    device=self.device))
            if self.m.late_statesync_node:
                # servers take snapshots; the late joiner fast-syncs
                # its tail after the snapshot restore
                cfg.base.snapshot_interval = 4
            cfg.save(cfg_path)
            mb = ",".join(m.spec for m in self.m.misbehaviors
                          if m.node == i)
            self.nodes.append(NodeProc(
                i, home, self.port("rpc", i), misbehavior=mb,
                pprof_port=pprof_port, device=self.device))

    def _make_seed_home(self) -> str:
        """Create a dedicated NON-validator seed node (reference e2e
        node role "seed"): fresh keys, the testnet's genesis, PEX seed
        mode, no peers of its own. Returns its id@addr for the
        validators' `seeds` config."""
        from ..config import Config
        from ..p2p.key import NodeKey
        from ..privval import FilePV

        home = os.path.join(self.out_dir, "seed")
        os.makedirs(os.path.join(home, "config"))
        os.makedirs(os.path.join(home, "data"))
        shutil.copy(os.path.join(self.out_dir, "node0", "config",
                                 "genesis.json"),
                    os.path.join(home, "config", "genesis.json"))
        nk = NodeKey.load_or_gen(
            os.path.join(home, "config", "node_key.json"))
        FilePV.generate(
            os.path.join(home, "config", "priv_validator_key.json"),
            os.path.join(home, "data", "priv_validator_state.json"))
        p2p_port = self.port("seed_p2p")
        cfg = Config()
        cfg.base.home = home
        cfg.base.moniker = "seed"
        cfg.base.fast_sync = True
        cfg.consensus.timeout_commit_ms = self.m.timeout_commit_ms
        cfg.p2p.laddr = f"tcp://127.0.0.1:{p2p_port}"
        cfg.p2p.seed_mode = True
        cfg.p2p.pex_ensure_period_s = 2.0
        cfg.rpc.laddr = f"tcp://127.0.0.1:{self.port('seed_rpc')}"
        cfg.save(os.path.join(home, "config", "config.toml"))
        self.seed = NodeProc(-1, home, self.port("seed_rpc"),
                             device=self.device)
        return f"{nk.id}@127.0.0.1:{p2p_port}"

    def start(self) -> None:
        if self.seed is not None:  # the discovery rendezvous point
            self.seed.start()
            self.log("started seed node")
        for app in self.apps:  # app servers first: nodes dial them
            app.start()
        if self.apps:
            self.log(f"started {len(self.apps)} external "
                     f"{self.m.abci} ABCI app servers")
        for signer in self.signers:  # sidecars redial until node is up
            signer.start()
        if self.signers:
            self.log(f"started {len(self.signers)} remote-signer "
                     "sidecars")
        held_back = (
            {self.m.nodes - 1} if self.m.late_statesync_node else set())
        started = [n for n in self.nodes if n.index not in held_back]
        for node in started:
            node.start()
        self.log(f"started {len(started)} nodes "
                 f"(pids {[n.pid for n in started]})")

    async def start_late_statesync_node(self) -> None:
        """Configure + boot the held-back node once snapshots exist:
        trust hash from a live RPC commit, rpc_servers pointing at two
        running nodes (reference node.go:589 wiring via [statesync])."""
        from ..config import Config

        late = self.nodes[-1]
        # a snapshot is taken at height 4 (interval 4); the light
        # provider probes trust..snapshot+2
        await self.wait_net_height(7)
        # Fetch the trust root from ANY live node, with retries: a
        # perturbation may have just killed/restarted the first one
        # (found by the combined statesync+perturbation scenario).
        commit = None
        for attempt in range(20):
            for node in self.nodes[:-1]:
                try:
                    commit = await self._rpc(node, "commit", height=2)
                    break
                except Exception:
                    continue
            if commit is not None:
                break
            await asyncio.sleep(1.0)
        if commit is None:
            raise RuntimeError("no live node to fetch the trust root")
        trust_hash = commit["signed_header"]["commit"]["block_id"]["hash"]
        cfg_path = os.path.join(late.home, "config", "config.toml")
        cfg = Config.load(cfg_path)
        cfg.statesync.enable = True
        cfg.statesync.rpc_servers = [
            f"127.0.0.1:{self.nodes[0].rpc_port}",
            f"127.0.0.1:{self.nodes[1].rpc_port}",
        ]
        cfg.statesync.trust_height = 2
        cfg.statesync.trust_hash = trust_hash
        cfg.save(cfg_path)
        self.log(f"starting late statesync node{late.index} "
                 f"(trust height 2, hash {trust_hash[:12]}...)")
        late.start()

    # -- RPC helpers --

    async def _rpc(self, node: NodeProc, method: str, **params):
        from ..rpc.jsonrpc import HTTPClient

        cli = HTTPClient("127.0.0.1", node.rpc_port, timeout=5)
        return await cli.call(method, **params)

    async def _debug_post(self, node: NodeProc, path: str,
                          payload: dict) -> dict:
        """POST JSON to the node's debug server (tiny HTTP/1.0)."""
        import json

        assert node.pprof_port, "node has no debug endpoint configured"
        body = json.dumps(payload).encode()
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", node.pprof_port)
        try:
            writer.write(
                f"POST {path} HTTP/1.0\r\n"
                f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            await writer.drain()
            raw = await asyncio.wait_for(reader.read(), timeout=10)
        finally:
            writer.close()
        head, _, resp_body = raw.partition(b"\r\n\r\n")
        return json.loads(resp_body)

    async def _debug_get(self, node: NodeProc, path: str) -> bytes:
        """GET from the node's debug server; raw body bytes."""
        assert node.pprof_port, "node has no debug endpoint configured"
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", node.pprof_port)
        try:
            writer.write(f"GET {path} HTTP/1.0\r\n\r\n".encode())
            await writer.drain()
            raw = await asyncio.wait_for(reader.read(), timeout=10)
        finally:
            writer.close()
        _, _, body = raw.partition(b"\r\n\r\n")
        return body

    async def collect_timeline(self) -> dict | None:
        """Height forensics over the live net (best-effort): pull each
        node's clock anchor + the last committed heights' spans from
        its debug server, reconstruct cross-node TIMELINE lines, and
        return the run summary (tools/forensics.timeline_summary).
        None when no node exposes a debug endpoint or nothing
        reconstructs — the report simply omits the section."""
        import json

        from ..tools import forensics

        nodes = [n for n in self.nodes if n.pprof_port
                 and n.proc is not None and n.proc.poll() is None]
        if not nodes:
            return None
        anchors: dict[int, int] = {}
        for n in nodes:
            try:
                a = json.loads(await self._debug_get(
                    n, "/debug/trace/anchor"))
                anchors[n.index] = a["wall_ns"] - a["mono_ns"]
            except Exception:
                pass
        # candidates: recent commit spans anywhere in the fleet
        heights: set[int] = set()
        per_node_docs: dict[int, dict] = {}
        for n in nodes:
            try:
                doc = json.loads(await self._debug_get(n, "/debug/trace"))
            except Exception:
                continue
            per_node_docs[n.index] = doc
            for ev in doc.get("traceEvents", []):
                if ev.get("name") == "consensus.commit":
                    h = (ev.get("args") or {}).get("height")
                    if h:
                        heights.add(h)
        timelines = []
        for h in sorted(heights)[-8:]:
            views: dict = {}
            for n in nodes:
                doc = per_node_docs.get(n.index)
                if doc is None:
                    continue
                views.update(forensics.from_chrome(
                    doc, h, f"node{n.index}",
                    offset_ns=anchors.get(n.index, 0)))
            tl = forensics.build_timeline(views, h)
            if tl is not None:
                timelines.append(tl)
                self.log(f"TIMELINE {json.dumps(tl, sort_keys=True)}")
        if not timelines:
            return None
        return forensics.timeline_summary(timelines)

    async def collect_launch_ledger(self) -> dict | None:
        """Per-node launch-ledger rollups over the live net
        (best-effort, like collect_timeline): {node label: rollup}
        from each debug server's /debug/launches, None when nothing
        answered or every ledger is empty. The reference's
        tools/launch_ledger.py reads the resulting report block
        directly. Beside the reference's keys, `launches` counts the
        node's records by kernel, backend, card name and verdict, with
        the lanes of each."""
        import json

        out: dict[str, dict] = {}
        for n in self.nodes:
            if not n.pprof_port or n.proc is None \
                    or n.proc.poll() is not None:
                continue
            try:
                doc = json.loads(await self._debug_get(
                    n, "/debug/launches"))
            except Exception:
                continue
            self.ledger_answered.append(f"node{n.index}")
            roll = doc.get("rollup") or {}
            if roll.get("records"):
                out[f"node{n.index}"] = {
                    "rollup": roll,
                    "watchdog": doc.get("watchdog"),
                    "hbm": doc.get("hbm"),
                    "launches": launch_summary(doc.get("records") or []),
                }
        return out or None

    @staticmethod
    def _sum_metric(metrics_text: str, name: str) -> float:
        """Sum every sample of a counter/gauge family in Prometheus
        text exposition (labels collapse)."""
        total = 0.0
        for line in metrics_text.splitlines():
            if line.startswith(name) and not line.startswith("#"):
                head, _, val = line.rpartition(" ")
                if head.partition("{")[0] == name:
                    try:
                        total += float(val)
                    except ValueError:
                        pass
        return total

    async def height_of(self, node: NodeProc) -> int:
        st = await self._rpc(node, "status")
        return int(st["sync_info"]["latest_block_height"])

    async def net_height(self) -> int:
        """Max height over reachable nodes."""
        best = 0
        for node in self.nodes:
            try:
                best = max(best, await self.height_of(node))
            except Exception:
                continue
        return best

    async def wait_net_height(self, h: int, timeout: float = 120.0,
                              stall_timeout: float | None = None) -> None:
        """Wait until the net's MAX height reaches h — progress-gated
        (wait_progress): only a stall (or the absolute cap) fails, not
        a fixed deadline that suite load can blow."""
        await wait_progress(
            self.net_height, lambda got: got >= h,
            timeout=timeout, stall_timeout=stall_timeout,
            what=f"net height {h}")

    async def wait_all_height(self, h: int, timeout: float = 120.0,
                              stall_timeout: float | None = None) -> None:
        """Wait for EVERY node to reach height h (progress-gated). A
        node whose RPC dies after it already reached h still counts —
        perturbations kill nodes that have done their part."""
        best: dict[int, int] = {}

        async def sample() -> dict[int, int]:
            for node in self.nodes:
                try:
                    got = await self.height_of(node)
                except Exception:
                    continue
                if got > best.get(node.index, 0):
                    best[node.index] = got
            return dict(best)

        await wait_progress(
            sample,
            lambda snap: all(snap.get(n.index, 0) >= h
                             for n in self.nodes),
            timeout=timeout, stall_timeout=stall_timeout,
            what=f"all nodes at height {h}")

    # -- load (reference load.go) --

    async def _load_loop(self) -> None:
        import base64
        import itertools

        delay = 1.0 / self.m.load_tx_rate
        for i in itertools.count():
            node = self.nodes[i % len(self.nodes)]
            tx = b"load-%d=%d" % (i, i)
            try:
                await self._rpc(node, "broadcast_tx_async",
                                tx=base64.b64encode(tx).decode())
                self._txs_sent += 1
            except Exception:
                pass  # node may be perturbed right now
            await asyncio.sleep(delay)

    def start_load(self) -> None:
        if self.m.load_tx_rate > 0:
            self._load_task = asyncio.get_running_loop().create_task(
                self._load_loop())

    def stop_load(self) -> None:
        if self._load_task is not None:
            self._load_task.cancel()
            self._load_task = None

    # -- perturbations (reference perturb.go:12-60) --

    async def apply(self, p: Perturbation) -> None:
        node = self.nodes[p.node]
        self.log(f"perturb: {p.op} node{p.node} at net height "
                 f"{await self.net_height()}")
        if p.op == "kill":
            if p.failpoint:
                await self._apply_kill_at_failpoint(p, node)
                return
            await asyncio.to_thread(node.kill9)
            await asyncio.sleep(1.0)
            node.start()  # must WAL-recover
        elif p.op == "restart":
            # to_thread: terminate() blocks in proc.wait(); inline it
            # would freeze load/polling for the whole shutdown.
            await asyncio.to_thread(node.terminate)
            node.start()
        elif p.op in ("pause", "disconnect"):
            node.sigstop()
            await asyncio.sleep(p.duration)
            node.sigcont()
        elif p.op == "disconnect_hard":
            # real TCP severance via the node's unsafe RPC hook: its
            # switch closes every conn (peers see resets) and refuses
            # redials for the window
            res = await self._rpc(node, "unsafe_net_sever",
                                  seconds=p.duration)
            self.log(f"perturb: node{p.node} dropped "
                     f"{res['connections_dropped']} conns")
            await asyncio.sleep(p.duration)
        elif p.op == "overload":
            await self._apply_overload(p, node)
        elif p.op == "spec_mismatch":
            await self._apply_spec_mismatch(p, node)
        elif p.op == "light_proxy":
            await self._apply_light_proxy(p, node)
        elif p.op == "statesync_poison":
            await self._apply_statesync_poison(p, node)
        elif p.op == "chaos":
            # arm a named failpoint through the node's debug endpoint
            # for the window, then disarm — the net must degrade and
            # recover, never wedge (the final wait_all_height is the
            # recovery assertion)
            spec: dict = {"name": p.failpoint, "action": p.action}
            if p.action == "delay":
                spec["delay_ms"] = p.delay_ms
            res = await self._debug_post(node, "/debug/failpoint", spec)
            assert "error" not in res, f"chaos arm failed: {res}"
            await asyncio.sleep(p.duration)
            await self._debug_post(node, "/debug/failpoint",
                                   {"name": p.failpoint,
                                    "action": "off"})
        else:  # pragma: no cover - manifest validated
            raise ValueError(p.op)

    async def _apply_statesync_poison(self, p: Perturbation,
                                      node: NodeProc) -> None:
        """Turn node p.node into a byzantine chunk server: arm
        `statesync.serve` corrupt so every snapshot chunk it serves is
        garbled in flight. The point STAYS armed through the late
        statesync node's whole restore (manifest validation guarantees
        late_statesync_node is on); check_statesync_poison() disarms
        it after wait_height and asserts the joiner's quarantine."""
        res = await self._debug_post(node, "/debug/failpoint",
                                     {"name": "statesync.serve",
                                      "action": "corrupt"})
        assert "error" not in res, f"statesync_poison arm failed: {res}"
        self._statesync_poisons.append(p)
        self.log(f"perturb: node{p.node} now serves corrupted "
                 "snapshot chunks (statesync.serve armed)")

    async def check_statesync_poison(self) -> None:
        """Post-run face of the poisoned-bootstrap invariant: the late
        joiner reached wait_height (wait_all_height already gated
        that — the poisoner never cost liveness). Here: disarm the
        poisoners, and for every poisoner that actually SERVED chunks
        assert the joiner quarantined a peer and needed more than one
        restore attempt (chunk routing is height/peer-set dependent, so
        a poisoner that never served is reported, not asserted)."""
        import json

        late = self.nodes[-1]
        for p in self._statesync_poisons:
            poisoner = self.nodes[p.node]
            fires = 0
            try:
                st = json.loads(await self._debug_get(
                    poisoner, "/debug/failpoint"))
                fires = int(st["statesync.serve"]["fires"])
            finally:
                await self._debug_post(poisoner, "/debug/failpoint",
                                       {"name": "statesync.serve",
                                        "action": "off"})
            status = json.loads(await self._debug_get(late, "/status"))
            ss = status.get("checks", {}).get("statesync", {})
            report = {"node": p.node, "chunks_poisoned": fires,
                      "restore_attempts": ss.get("restore_attempt", 0),
                      "quarantined": ss.get("quarantined_peers", [])}
            self.statesync_poison_reports.append(report)
            self.log(f"perturb: statesync_poison report {report}")
            if fires > 0:
                assert report["quarantined"], (
                    f"node{p.node} served {fires} corrupted chunks but "
                    "the late joiner quarantined nobody")
                assert report["restore_attempts"] >= 2, (
                    "poisoned restore completed without a retry — the "
                    "corrupted chunks were applied unverified")

    async def _apply_kill_at_failpoint(self, p: Perturbation,
                                       node: NodeProc) -> None:
        """Crash the node AT a named commit-pipeline point (arm
        `crash` via the debug endpoint) instead of an arbitrary
        SIGKILL, restart it, and record whether handshake recovery
        brought it back past its kill height — the e2e face of
        tools/crash_sweep.py. Falls back to SIGKILL if the armed point
        does not fire within the window (the perturbation must not
        wedge the run: e.g. statesync.chunk never fires on a synced
        node)."""
        h0 = await self.net_height()
        res = await self._debug_post(node, "/debug/failpoint",
                                     {"name": p.failpoint,
                                      "action": "crash"})
        assert "error" not in res, f"kill-failpoint arm failed: {res}"
        crashed = False
        for _ in range(int(max(p.duration, 10.0) * 4)):
            if not node.alive():
                crashed = True
                break
            await asyncio.sleep(0.25)
        if not crashed:
            self.log(f"perturb: kill failpoint {p.failpoint} never "
                     f"fired on node{p.node}; falling back to SIGKILL")
            await asyncio.to_thread(node.kill9)
        elif node.proc is not None:
            node.proc.wait()  # reap
        await asyncio.sleep(1.0)
        node.start()  # clean boot: handshake must heal the skew

        # recovery assertion: the node's OWN height must pass its
        # kill-time net height (bounded; the final wait_all_height
        # still gates the whole run)
        recovered_h = 0
        recovered = False
        async def sample():
            nonlocal recovered_h
            try:
                recovered_h = max(recovered_h,
                                  await self.height_of(node))
            except Exception:
                pass
            return recovered_h

        try:
            await wait_progress(sample, lambda h: h > h0,
                                timeout=60, stall_timeout=45,
                                what=f"node{p.node} recovery past "
                                     f"height {h0}")
            recovered = True
        except TimeoutError:
            pass
        report = {"node": p.node, "failpoint": p.failpoint,
                  "crashed_at_point": crashed, "height_at_kill": h0,
                  "recovered": recovered,
                  "recovered_height": recovered_h}
        self.kill_reports.append(report)
        self.log(f"perturb: kill-at-failpoint report {report}")
        assert recovered, (
            f"node{p.node} failed to recover past height {h0} after "
            f"crash at {p.failpoint}")

    async def _apply_spec_mismatch(self, p: Perturbation,
                                   node: NodeProc) -> None:
        """Wrong-timestamp flood into the verify-ahead plane: arm
        `consensus.speculate` corrupt on the node, so every lane
        entering a speculative launch verifies (and later matches)
        against a corrupted timestamp — at commit every speculated
        lane mismatches. Asserts the degradation contract: hits drop
        to ZERO for the window, the fallback path keeps serving
        correct verdicts (misses climb, every commit still validates)
        and the net keeps committing throughout."""
        import json

        res = await self._debug_post(node, "/debug/failpoint",
                                     {"name": "consensus.speculate",
                                      "action": "corrupt"})
        assert "error" not in res, f"spec_mismatch arm failed: {res}"
        h0 = await self.height_of(node)
        try:
            # two heights ON THE TARGET NODE under the armed corrupt:
            # every speculation entry a subsequent serve can touch was
            # launched (and corrupted) AFTER arming — pre-arm launches
            # must not count as window hits. Gated on the node's OWN
            # height (not the net max — a lagging target could still
            # serve a pre-arm entry after a net-max settle).
            own = 0

            async def sample():
                nonlocal own
                try:
                    own = max(own, await self.height_of(node))
                except Exception:
                    pass
                return own

            await wait_progress(sample, lambda h: h >= h0 + 2,
                                timeout=60,
                                what=f"node{p.node} past height "
                                     f"{h0 + 2} under spec_mismatch")
            def lane_misses(spec: dict) -> int:
                # ONLY the per-lane fallback reasons prove a lane
                # actually traversed the armed corrupt path — no_plan
                # counts commits the plane never speculated (catch-up
                # traffic) and must not satisfy the exercised guard
                return sum(v for k, v in spec.get("misses", {}).items()
                           if k != "no_plan")

            st = json.loads(await self._debug_get(node, "/status"))
            spec0 = st["checks"].get("speculation")
            assert spec0 is not None, (
                "no speculation check in /status — is [speculation] "
                "enabled on the target node?")
            hits0 = spec0["hits"]
            misses0 = lane_misses(spec0)
            await asyncio.sleep(max(p.duration, 2.0))
            h1 = await self.net_height()
            st = json.loads(await self._debug_get(node, "/status"))
            spec1 = st["checks"]["speculation"]
            hits1 = spec1["hits"]
            misses1 = lane_misses(spec1)
        finally:
            await self._debug_post(node, "/debug/failpoint",
                                   {"name": "consensus.speculate",
                                    "action": "off"})
        assert hits1 - hits0 == 0, (
            f"speculation served {hits1 - hits0} hits during the "
            "wrong-timestamp flood window")
        assert misses1 - misses0 > 0, (
            "no speculation misses during the flood window — the "
            "plane wasn't exercised")
        assert h1 >= h0 + 2, (
            f"net stalled under spec_mismatch ({h0} -> {h1})")
        # fallback verdicts stayed correct: the net keeps committing
        # past the window (the final no-fork check covers the hashes)
        await self.wait_net_height(h1 + 1, timeout=60)
        report = {"node": p.node, "height_at_arm": h0,
                  "hits_delta": hits1 - hits0,
                  "misses_delta": misses1 - misses0,
                  "height_after": h1}
        self.spec_mismatch_reports.append(report)
        self.log(f"perturb: spec_mismatch report {report}")

    async def _apply_light_proxy(self, p: Perturbation,
                                 node: NodeProc) -> None:
        """Boot a light serving plane + proxy IN THE RUNNER PROCESS
        against `node`'s RPC (another live node, when present, rides
        along as a witness), then prove the serving-plane contract on
        a real net: (1) concurrent requests with height overlap
        coalesce — verify launches ≪ requests, bounded by distinct
        heights; (2) every served header matches the primary's chain;
        (3) with `light.verify` delayed, a flood of fresh-height
        requests sheds-newest with 429s while the backing net keeps
        committing and the pending-verify queue stays within its
        bound. The plane runs in-process, so metrics/failpoints are
        the runner's own — no debug endpoint needed — and on the
        runner's device (check_runnable pinned it)."""
        from ..config import LightConfig
        from ..libs import failpoints
        from ..libs.db import MemDB
        from ..libs.metrics import light_metrics
        from ..light import (
            Client, LightServingShedError, LightStore, ServingPlane,
            TrustOptions,
        )
        from ..light.provider import RPCProvider
        from ..light.proxy import LightProxy
        from ..rpc.jsonrpc import HTTPClient, RPCError

        period = 3600 * 1_000_000_000  # 1 h: plenty for a test net
        prov = RPCProvider("127.0.0.1", node.rpc_port)
        witnesses = []
        for other in self.nodes:
            if other.index != node.index and other.alive():
                witnesses.append(
                    RPCProvider("127.0.0.1", other.rpc_port))
                break
        trusted = await prov.light_block(1)
        cl = Client(
            self.m.chain_id or "e2e-chain",
            TrustOptions(period_ns=period, height=1,
                         hash=trusted.hash()),
            prov, witnesses, LightStore(MemDB()))
        # default pending bound: phase 1 proves coalescing with ZERO
        # sheds, and one non-adjacent verification alone parks two
        # commit checks — a tiny bound here would shed its own phase
        # (the flood phase below builds its own tiny-bound plane)
        plane = ServingPlane(cl, LightConfig(flush_ms=10.0))
        proxy = LightProxy(
            cl, forward_client=HTTPClient("127.0.0.1", node.rpc_port),
            plane=plane)
        port = await proxy.listen("127.0.0.1", 0)
        met = light_metrics()

        def launches() -> int:
            return int(sum(met.verify_launches.value(backend=b)
                           for b in ("device", "host", "host_recheck")))

        report: dict = {"node": p.node}
        try:
            # -- coalescing + parity: 24 concurrent requests over ≤ 4
            # distinct committed heights through the proxy
            head = await self.height_of(node)
            span = list(range(max(2, head - 3), head + 1))
            http = HTTPClient("127.0.0.1", port)
            before = launches()
            res = await asyncio.gather(
                *(http.call("commit", height=span[i % len(span)])
                  for i in range(24)))
            n_launches = launches() - before
            # launches ≪ requests is the coalescing claim. NOT
            # "≤ distinct heights": generated nets rotate validator
            # sets, and a rotation between the trust root and the
            # head adds bisection pivots (extra flushes) to a
            # perfectly coalescing plane — the strict bound lives in
            # test_light_serving.py over a constant-valset chain.
            assert n_launches < 24 // 2, (
                f"coalescing failed: {n_launches} launches for 24 "
                f"requests over {len(span)} distinct heights")
            refs = {h: await self._rpc(node, "commit", height=h)
                    for h in span}
            for i, cm in enumerate(res):
                want = refs[span[i % len(span)]]
                assert cm["signed_header"]["commit"]["block_id"] \
                    == want["signed_header"]["commit"]["block_id"], \
                    f"served header diverges at {span[i % len(span)]}"
            report.update(requests=24,
                          distinct_heights=len(span),
                          verify_launches=n_launches,
                          coalesced=plane.coalesced)
        finally:
            proxy.close()
            plane.close()

        # -- flood dies at the plane: a FRESH plane (tiny bound, empty
        # store — every request is real verification work) with the
        # verify launch stalled via the light.verify failpoint. The
        # distinct-height fan-out must shed-newest with 429s, the
        # pending-verify depth must never pass its bound, the /status
        # body must read degraded while saturated, and the backing
        # net must keep committing through it all.
        h0 = await self.net_height()
        cl2 = Client(
            self.m.chain_id or "e2e-chain",
            TrustOptions(period_ns=period, height=1,
                         hash=trusted.hash()),
            RPCProvider("127.0.0.1", node.rpc_port), [],
            LightStore(MemDB()))
        flood_plane = ServingPlane(
            cl2, LightConfig(flush_ms=10.0, pending_max=2))
        proxy2 = LightProxy(cl2, plane=flood_plane)
        port2 = await proxy2.listen("127.0.0.1", 0)
        # generous timeout: admitted requests serialize through the
        # single delayed flusher (up to ~5 s per flush, plus
        # bisection pivots on rotating-valset nets) — the default
        # 10 s would TimeoutError an ADMITTED request and abort the
        # perturbation instead of reporting the shed contract
        http2 = HTTPClient("127.0.0.1", port2, timeout=60.0)
        try:
            failpoints.arm("light.verify", "delay",
                           delay_ms=min(max(p.duration, 1.0), 5.0)
                           * 1000)
            try:
                fresh = list(range(2, head + 1))
                shed = ok = 0
                max_depth = 0

                async def one(h):
                    nonlocal shed, ok
                    try:
                        await http2.call("commit", height=h)
                        ok += 1
                    except RPCError as e:
                        assert e.code == 429, f"non-429 shed: {e}"
                        shed += 1
                    except asyncio.TimeoutError:
                        # an admitted request outlasting even the
                        # generous client timeout is tolerated, not
                        # fatal — the contract under test is the
                        # shed/bound/liveness set below, and a
                        # timeout is neither a shed nor a serve
                        pass

                tasks = [asyncio.ensure_future(one(h)) for h in fresh]
                status_during = "ok"
                saw_saturated = False
                while not all(t.done() for t in tasks):
                    # one status_check() reads depth and derives the
                    # status from that same read — sampling the body
                    # (not collector.depth() separately) keeps the
                    # saturated-implies-degraded assertion race-free
                    body = flood_plane.status_check()
                    max_depth = max(max_depth, body["queue_depth"])
                    if body["queue_depth"] >= \
                            0.8 * flood_plane.collector.pending_max:
                        saw_saturated = True
                        status_during = body["status"]
                    await asyncio.sleep(0.02)
                await asyncio.gather(*tasks)
            finally:
                failpoints.disarm("light.verify")
            assert shed > 0, "flood produced no 429 sheds"
            if saw_saturated:
                # guarded (the 20 ms sampler may miss a short-lived
                # saturation window entirely, and that's not a
                # failure) — but a sample TAKEN while saturated must
                # have read degraded
                assert status_during == "degraded", (
                    f"/status read {status_during!r} while the "
                    "pending-verify backlog was saturated")
            assert max_depth <= flood_plane.collector.pending_max, (
                f"pending-verify depth {max_depth} exceeded bound")
            # heights on the backing net stayed live through the flood
            await self.wait_net_height(h0 + 1, timeout=60)
            # and a fresh request after the stall clears must verify
            await http2.call("commit", height=2)
            report.update(flood_shed=shed, flood_ok=ok,
                          max_queue_depth=max_depth,
                          status_during=status_during,
                          net_advanced=True)
        finally:
            proxy2.close()
            flood_plane.close()
        self.light_proxy_reports.append(report)
        self.log(f"perturb: light_proxy report {report}")

    async def _apply_overload(self, p: Perturbation,
                              node: NodeProc) -> None:
        """Create overload DETERMINISTICALLY (the chaos failpoints): a
        delay failpoint throttles the node's hot path while a tx flood
        arrives faster than it can drain — then verify the node
        degrades gracefully: heights advance monotonically, at least
        one shed counter climbs, no tracked queue exceeds its bound,
        and the /status overload level clears after the window."""
        import base64
        import json

        fp = p.failpoint or "device.verify"
        spec: dict = {"name": fp, "action": p.action}
        if p.action == "delay":
            spec["delay_ms"] = p.delay_ms
        res = await self._debug_post(node, "/debug/failpoint", spec)
        assert "error" not in res, f"overload arm failed: {res}"

        before = (await self._debug_get(node, "/metrics")).decode()
        shed_before = self._sum_metric(before, "overload_shed_total")
        adm_shed_before = self._sum_metric(before, "admission_shed_total")

        async def submit(tx: bytes) -> None:
            await self._rpc(node, "broadcast_tx_async",
                            tx=base64.b64encode(tx).decode())

        flood = asyncio.get_running_loop().create_task(
            tx_flood(submit, p.tx_rate, p.duration,
                     signed_frac=p.tx_signed,
                     garbage_frac=p.tx_garbage))
        heights: list[int] = []
        levels: list[str] = []
        bounded = True
        try:
            while not flood.done():
                try:
                    # sample via the DEBUG endpoint: the RPC listener
                    # is deliberately shedding right now
                    st = json.loads(await self._debug_get(node,
                                                          "/status"))
                    heights.append(
                        st["checks"]["consensus"]["height"])
                    oc = st["checks"].get("overload", {})
                    levels.append(oc.get("level", "?"))
                    for q in oc.get("queues", {}).values():
                        if q["capacity"] and q["depth"] > q["capacity"]:
                            bounded = False
                except Exception:
                    pass  # the node is BUSY; that's the scenario
                await asyncio.sleep(0.5)
        finally:
            sent = await flood
            await self._debug_post(node, "/debug/failpoint",
                                   {"name": fp, "action": "off"})

        after = (await self._debug_get(node, "/metrics")).decode()
        shed_delta = self._sum_metric(after, "overload_shed_total") \
            - shed_before
        adm_shed_delta = self._sum_metric(after, "admission_shed_total") \
            - adm_shed_before
        # recovery: the overload level must clear once the flood stops
        cleared = False
        for _ in range(60):
            try:
                st = json.loads(await self._debug_get(node, "/status"))
                if st["checks"]["overload"]["level"] == "ok":
                    cleared = True
                    break
            except Exception:
                pass
            await asyncio.sleep(1.0)
        report = {"node": p.node, "failpoint": fp, "txs_sent": sent,
                  "heights": heights, "levels": levels,
                  "shed_delta": shed_delta, "bounded": bounded,
                  "cleared": cleared}
        if p.tx_garbage > 0:
            # a garbage-envelope flood MUST move the admission shed
            # counters — junk dying at the device, not in the app
            report["admission_shed_delta"] = adm_shed_delta
            assert adm_shed_delta > 0, (
                f"overload flood with tx_garbage={p.tx_garbage} moved "
                "no admission_shed_total counters")
        self.overload_reports.append(report)
        self.log(f"perturb: overload report {report}")

    # -- validator-set schedule (reference manifest.go validator
    # schedules; kvstore "val:<pub>!<power>" txs route through
    # EndBlock -> update_with_change_set -> device-table rewarm) --

    def _node_pub_hex(self, index: int) -> str:
        import json as _json

        key_path = os.path.join(self.out_dir, f"node{index}",
                                "config", "priv_validator_key.json")
        if not os.path.exists(key_path):  # privval=tcp: key moved to
            key_path = os.path.join(      # the signer sidecar home
                self.out_dir, f"signer{index}", "config",
                "priv_validator_key.json")
        with open(key_path) as f:
            return _json.load(f)["pub_key"]

    async def apply_valupdate(self, vu) -> None:
        import base64

        from ..abci.kvstore import encode_validator_tx

        pub_hex = self._node_pub_hex(vu.node)
        tx = encode_validator_tx(pub_hex, vu.power)
        self.log(f"valupdate: node{vu.node} power -> {vu.power} at net "
                 f"height {await self.net_height()}")
        # Submit to any LIVE node, preferring one other than the node
        # being updated (it may be leaving the set); a co-scheduled
        # perturbation or a held-back statesync node means a blind
        # target can be down — retry around the ring like the load
        # loop tolerates perturbed nodes.
        last_err: Exception | None = None
        for attempt in range(30):
            target = self.nodes[(vu.node + 1 + attempt)
                                % len(self.nodes)]
            try:
                res = await self._rpc(target, "broadcast_tx_sync",
                                      tx=base64.b64encode(tx).decode())
                assert int(res.get("code", 0)) == 0, \
                    f"valupdate rejected: {res}"
                break
            except AssertionError:
                raise
            except Exception as e:
                # "already in cache" means the tx IS in the mempool —
                # a lost response on a successful broadcast, or a
                # prior attempt that gossiped before its node dropped.
                # That is success, not a dead node.
                if "already in cache" in str(e):
                    break
                last_err = e  # node down/perturbed: try the next
                await asyncio.sleep(0.5)
        else:
            raise RuntimeError(
                f"no live node accepted the validator tx: {last_err}")
        self._expected_powers[pub_hex.upper()] = vu.power
        self._valset_changes += 1

    async def check_valset(self) -> None:
        """The final validator set reflects every scheduled update.
        Powers take effect at H_include+2 and inclusion can lag a
        co-scheduled perturbation's retries while the net keeps
        committing, so poll (bounded) instead of asserting one
        latest-height snapshot."""
        if not self._expected_powers:
            return
        import base64 as _b64

        deadline = asyncio.get_running_loop().time() + 30.0
        while True:
            vals = await self._rpc(self.nodes[0], "validators",
                                   per_page=100)
            got = {v["pub_key"]["value"]: int(v["voting_power"])
                   for v in vals["validators"]}
            mismatch = None
            for pub_hex, power in self._expected_powers.items():
                b64 = _b64.b64encode(bytes.fromhex(pub_hex)).decode()
                if (power == 0 and b64 in got) or (
                        power != 0 and got.get(b64) != power):
                    mismatch = (f"validator {pub_hex[:12]} power "
                                f"{got.get(b64)} != scheduled {power}")
                    break
            if mismatch is None:
                return
            if asyncio.get_running_loop().time() > deadline:
                raise AssertionError(mismatch)
            await asyncio.sleep(0.5)

    # -- the full run --

    async def run(self) -> dict:
        self.check_runnable()
        try:
            self.setup()
            self.start()
            self.start_load()
            events = (
                [(p.at_height, 0, p) for p in self.m.perturbations]
                + [(vu.at_height, 1, vu)
                   for vu in self.m.validator_updates]
            )
            for _, kind, ev in sorted(events, key=lambda e: e[:2]):
                await self.wait_net_height(ev.at_height)
                if kind == 0:
                    await self.apply(ev)
                else:
                    await self.apply_valupdate(ev)
            if self.m.late_statesync_node:
                await self.start_late_statesync_node()
            await self.wait_all_height(self.m.wait_height)
            if self._statesync_poisons:
                await self.check_statesync_poison()
            self.stop_load()
            await self.check_valset()
            report = await self.check()
            report["txs_sent"] = self._txs_sent
            report["valset_changes"] = self._valset_changes
            if self.m.generator_seed is not None:
                # reproduce this exact net from the report alone:
                #   python -m tendermint_tpu_torch.e2e.generate --seed <it>
                report["generator_seed"] = self.m.generator_seed
            if self.kill_reports:
                report["kill_recoveries"] = self.kill_reports
            if self.light_proxy_reports:
                report["light_proxy"] = self.light_proxy_reports
            if self.spec_mismatch_reports:
                report["spec_mismatch"] = self.spec_mismatch_reports
            if self.statesync_poison_reports:
                report["statesync_poison"] = self.statesync_poison_reports
            try:
                timeline = await self.collect_timeline()
            except Exception as e:  # forensics never fails the run
                self.log(f"timeline collection failed: {e!r}")
                timeline = None
            if timeline is not None:
                report["timeline"] = timeline
            try:
                ledger = await self.collect_launch_ledger()
            except Exception as e:  # attribution never fails the run
                self.log(f"launch-ledger collection failed: {e!r}")
                ledger = None
            if ledger is not None:
                report["launch_ledger"] = ledger
            return report
        finally:
            self.stop_load()
            self.cleanup()

    async def check(self) -> dict:
        """All nodes at wait_height agree on every block hash — the
        no-fork assertion (reference test/e2e/tests/block_test.go) —
        and committed evidence is counted (evidence_test.go)."""
        h = self.m.wait_height
        hashes: dict[int, set] = {}
        evidence = 0
        for node in self.nodes:
            for height in range(1, h + 1):
                try:
                    b = await self._rpc(node, "block", height=height)
                except Exception:
                    # a state-synced node legitimately has no blocks
                    # below its snapshot height
                    continue
                hashes.setdefault(height, set()).add(
                    b["block_id"]["hash"])
                if node.index == 0:
                    evidence += len(
                        b["block"]["evidence"]["evidence"])
        forks = {h_: v for h_, v in hashes.items() if len(v) > 1}
        assert not forks, f"FORK detected: {forks}"
        # live peer counts (reference e2e net_test): min across nodes,
        # collected while the net is still up — the seed-bootstrap
        # scenario asserts discovery produced a real mesh from this.
        # Best of a few samples per node: a seed hanging up after
        # serving addresses makes single-sample counts transiently low.
        best = [-1] * len(self.nodes)
        for _ in range(3):
            for k, node in enumerate(self.nodes):
                try:
                    ni = await self._rpc(node, "net_info")
                    best[k] = max(best[k], int(ni["n_peers"]))
                except Exception:
                    pass
            await asyncio.sleep(1.0)
        return {"ok": True, "height": h, "nodes": len(self.nodes),
                "evidence_committed": evidence,
                "min_peers": min(best) if best else 0}

    def cleanup(self) -> None:
        for node in self.nodes:
            try:
                node.sigcont()  # in case it is stopped
            except Exception:
                pass
            node.terminate()
        for app in self.apps:
            app.terminate()
        for signer in self.signers:
            signer.terminate()
        if self.seed is not None:
            self.seed.terminate()


def launch_summary(records: list[dict]) -> list[dict]:
    """Launch-ledger records counted by (kernel, backend, card name,
    verdict), each with its lanes a launch in order."""
    groups: dict[tuple, dict] = {}
    for r in records:
        key = (r.get("kernel"), r.get("backend"), r.get("device_name"),
               r.get("verdict"))
        g = groups.setdefault(key, dict(zip(
            ("kernel", "backend", "device_name", "verdict"), key),
            launches=0, lanes=[]))
        g["launches"] += 1
        g["lanes"].append(r.get("lanes", 0))
    return list(groups.values())


def main(argv=None) -> int:
    import argparse
    import json

    from ..device import NoDeviceError

    ap = argparse.ArgumentParser(
        prog="tendermint-tpu-e2e", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("manifest")
    ap.add_argument("--out", default="./e2e-net")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="every child's device: the card (default) or "
                         "the plain versions on the CPU")
    args = ap.parse_args(argv)
    manifest = Manifest.load(args.manifest)
    runner = Runner(manifest, args.out, device=args.device)
    try:
        report = asyncio.run(runner.run())
    except NoDeviceError as e:
        print(f"{type(e).__name__}: {e} (or pass --device cpu)",
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps(report, sort_keys=True, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
