"""Exhaustive crash-point recovery sweep over the commit pipeline
(reference: the repository's root tools/crash_sweep.py, the same specs
and invariants, over the port's nodes).

For every commit-pipeline failpoint (libs/failpoints.py
COMMIT_PIPELINE — WAL fsync, KV batch, block-store save, the six
legacy consensus/apply boundaries, privval LastSignState persist) this
harness arms a `crash` action via TM_TPU_FAILPOINTS, boots a REAL
solo-validator node subprocess (`python -m tendermint_tpu_torch.cmd
start --device D`, through the e2e runner's NodeProc), lets the armed
point kill it hard (os._exit, no cleanup) mid-height, restarts it
clean, and asserts the crash-recovery invariants:

  1. liveness    — the restarted node advances >= 2 heights past where
                   it came back up (WAL replay + handshake healed the
                   skew instead of wedging);
  2. app oracle  — every committed header's app_hash equals the
                   clean-run oracle's at the same height (recovery
                   neither lost nor double-applied app state);
  3. monotone    — RPC-sampled heights never regress;
  4. stores      — after a final graceful stop, the on-disk stores are
                   mutually consistent: state height within one of the
                   block store's, a block meta for every stored
                   height, ABCI responses + next valset present for
                   the state height;
  5. privval     — the signing state file never regresses across the
                   crash/restart (height/round/step monotone), so the
                   double-sign protection survived.

tools/check_recovery.py lints that SWEEP_SPECS covers exactly the
COMMIT_PIPELINE catalog.

CLI:  python -m tendermint_tpu_torch.tools.crash_sweep
          [--points wal.fsync,db.set] [--out DIR] [--device {cuda,cpu}]
"""

from __future__ import annotations

import asyncio
import json
import os
import sys

from ..libs.failpoints import COMMIT_PIPELINE

# apart from the reference sweep's 29100, so the two never collide
BASE_PORT = 39100

# point -> TM_TPU_FAILPOINTS spec for the crashing boot. The nth
# values are tuned so the process survives genesis and dies MID-HEIGHT
# a height or two in (frequently-hit points get larger ordinals); any
# firing is a legal crash interleaving — recovery must heal them all.
SWEEP_SPECS: dict[str, str] = {
    "wal.fsync": "wal.fsync=crash;nth=12",
    "db.set": "db.set=crash;nth=9",
    "store.save_block": "store.save_block=crash;nth=2",
    "consensus.commit.block_saved":
        "consensus.commit.block_saved=crash;nth=2",
    "consensus.commit.wal_delimited":
        "consensus.commit.wal_delimited=crash;nth=2",
    "state.apply.block_executed":
        "state.apply.block_executed=crash;nth=2",
    "state.apply.responses_saved":
        "state.apply.responses_saved=crash;nth=2",
    "state.apply.app_committed":
        "state.apply.app_committed=crash;nth=2",
    "state.apply.state_saved":
        "state.apply.state_saved=crash;nth=2",
    "privval.save": "privval.save=crash;nth=5",
}
assert set(SWEEP_SPECS) == set(COMMIT_PIPELINE)


def _make_home(out_dir: str, port_off: int | None) -> tuple[str, int]:
    """A one-validator testnet home; its RPC port. `port_off` None
    takes the node's ports from the OS."""
    from ..cmd import main as cli_main
    from ..config import Config
    from ..e2e.runner import free_port

    rc = cli_main(["testnet", "--v", "1", "--o", out_dir,
                   "--chain-id", "crash-sweep-chain",
                   "--starting-port", str(BASE_PORT + (port_off or 0))])
    assert rc == 0, "testnet generation failed"
    home = os.path.join(out_dir, "node0")
    cfg_path = os.path.join(home, "config", "config.toml")
    cfg = Config.load(cfg_path)
    cfg.base.home = home
    cfg.consensus.timeout_commit_ms = 100
    if port_off is None:
        rpc_port = free_port()
        cfg.p2p.laddr = f"tcp://127.0.0.1:{free_port()}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc_port}"
    else:
        rpc_port = BASE_PORT + port_off + 1000
    cfg.save(cfg_path)
    return home, rpc_port


async def _height(rpc_port: int) -> int:
    from ..rpc.jsonrpc import HTTPClient

    st = await HTTPClient("127.0.0.1", rpc_port, timeout=5).call("status")
    return int(st["sync_info"]["latest_block_height"])


async def _app_hashes(rpc_port: int, upto: int) -> dict[int, str]:
    from ..rpc.jsonrpc import HTTPClient

    cli = HTTPClient("127.0.0.1", rpc_port, timeout=5)
    out: dict[int, str] = {}
    for h in range(1, upto + 1):
        b = await cli.call("block", height=h)
        out[h] = b["block"]["header"]["app_hash"]
    return out


def _privval_hrs(home: str) -> tuple[int, int, int]:
    path = os.path.join(home, "data", "priv_validator_state.json")
    with open(path) as f:
        d = json.load(f)
    return int(d["height"]), int(d["round"]), int(d["step"])


def _check_store_consistency(home: str) -> dict:
    """Open the (stopped) node's stores directly and assert the
    cross-store invariants the reconciler guarantees."""
    from ..libs.db import SqliteDB
    from ..state.store import Store
    from ..store import BlockStore

    data = os.path.join(home, "data")
    bs_db = SqliteDB(os.path.join(data, "blockstore.sqlite"))
    st_db = SqliteDB(os.path.join(data, "state.sqlite"))
    try:
        bs = BlockStore(bs_db)
        st = Store(st_db)
        state = st.load()
        assert state is not None, "state store empty after recovery"
        sh, bh = state.last_block_height, bs.height
        assert bh - 1 <= sh <= bh, \
            f"state height {sh} vs block store {bh}: illegal skew"
        for h in range(bs.base, bh + 1):
            assert bs.load_block_meta(h) is not None, \
                f"missing block meta at {h} (base {bs.base}, height {bh})"
        assert st.load_validators(sh + 1) is not None, \
            f"no validator set stored for next height {sh + 1}"
        assert st.load_abci_responses(sh) is not None, \
            f"no ABCI responses stored for state height {sh}"
        return {"state_height": sh, "store_height": bh}
    finally:
        bs_db.close()
        st_db.close()


async def _run_case_async(out_dir: str, point: str, spec: str,
                          port_off: int | None,
                          oracle: dict[int, str] | None,
                          device: str = "cuda", log=print) -> dict:
    from ..e2e.runner import NodeProc, wait_progress

    home, rpc_port = _make_home(out_dir, port_off)
    node = NodeProc(0, home, rpc_port, device=device)
    node.start(extra_env={"TM_TPU_FAILPOINTS": spec})
    report: dict = {"point": point, "spec": spec}
    try:
        rc = await asyncio.to_thread(node.proc.wait, 120)
        assert rc == 1, (
            f"node should have crashed at {point} (rc={rc}); log tail:\n"
            + open(node.log_path, "rb").read()[-2000:].decode(
                "utf-8", "replace"))
        pv_crashed = _privval_hrs(home)
        report["privval_at_crash"] = pv_crashed

        node.start()  # clean env: recovery must heal the interleaving
        heights: list[int] = []

        async def sample():
            try:
                h = await _height(rpc_port)
            except Exception:
                return -1
            if h >= 0:
                heights.append(h)
            return h

        # liveness: up, then two MORE heights than it came back at
        await wait_progress(sample, lambda h: h >= 1,
                            timeout=60, stall_timeout=45,
                            what=f"post-crash restart ({point})")
        h0 = heights[-1]
        await wait_progress(sample, lambda h: h >= h0 + 2,
                            timeout=60, stall_timeout=45,
                            what=f"post-recovery height {h0 + 2} "
                                 f"({point})")
        committed = [h for h in heights if h >= 0]
        assert committed == sorted(committed), \
            f"height regressed after recovery: {committed}"
        report["resumed_at"] = h0
        report["advanced_to"] = committed[-1]

        # app-hash oracle at every common height
        hashes = await _app_hashes(rpc_port, committed[-1])
        if oracle is not None:
            for h, ah in hashes.items():
                if h in oracle:
                    assert ah == oracle[h], (
                        f"app hash diverged from clean-run oracle at "
                        f"height {h}: {ah} != {oracle[h]} ({point})")
        report["app_hashes_checked"] = len(hashes)
    finally:
        node.terminate()

    # post-mortem: on-disk stores mutually consistent
    report.update(_check_store_consistency(home))
    pv_final = _privval_hrs(home)
    assert pv_final >= report["privval_at_crash"], (
        f"privval sign state regressed across crash/restart: "
        f"{pv_final} < {report['privval_at_crash']}")
    report["privval_final"] = pv_final
    report["ok"] = True
    log(f"crash_sweep: {point} ok "
        f"(resumed {report['resumed_at']} -> {report['advanced_to']})")
    return report


def run_case(out_dir: str, point: str, port_off: int | None,
             oracle: dict[int, str] | None = None,
             spec: str | None = None, device: str = "cuda",
             log=print) -> dict:
    """One crash/restart/verify case (blocking). `oracle` maps height
    -> clean-run app hash hex; None skips the oracle invariant."""
    return asyncio.run(_run_case_async(
        out_dir, point, spec or SWEEP_SPECS[point], port_off, oracle,
        device=device, log=log))


def oracle_run(out_dir: str, port_off: int | None, upto: int = 8,
               device: str = "cuda", log=print) -> dict[int, str]:
    """Clean solo run to `upto` heights; returns height -> app hash
    hex (the sweep's oracle)."""
    from ..e2e.runner import NodeProc, wait_progress

    home, rpc_port = _make_home(out_dir, port_off)
    node = NodeProc(0, home, rpc_port, device=device)
    node.start()

    async def go() -> dict[int, str]:
        async def sample():
            try:
                return await _height(rpc_port)
            except Exception:
                return -1

        await wait_progress(sample, lambda h: h >= upto,
                            timeout=120, stall_timeout=60,
                            what=f"oracle height {upto}")
        return await _app_hashes(rpc_port, upto)

    try:
        hashes = asyncio.run(go())
    finally:
        node.terminate()
    log(f"crash_sweep: oracle run committed {len(hashes)} heights")
    return hashes


def main(argv=None) -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(
        prog="crash_sweep", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--points", default="",
                    help="comma-separated subset (default: all)")
    ap.add_argument("--out", default="",
                    help="work dir (default: a temp dir)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the nodes' device: the card (default) or the "
                         "plain versions on the CPU")
    args = ap.parse_args(argv)
    points = [p for p in args.points.split(",") if p] or \
        list(COMMIT_PIPELINE)
    unknown = set(points) - set(SWEEP_SPECS)
    if unknown:
        ap.error(f"unknown commit-pipeline points: {sorted(unknown)}")

    workdir = args.out or tempfile.mkdtemp(prefix="crash-sweep-")
    oracle = oracle_run(os.path.join(workdir, "oracle"), 0,
                        device=args.device)
    failures = 0
    for i, point in enumerate(points):
        case_dir = os.path.join(workdir, f"case-{point.replace('.', '_')}")
        try:
            run_case(case_dir, point, 10 * (i + 1), oracle=oracle,
                     device=args.device)
        except Exception as e:
            failures += 1
            print(f"crash_sweep: {point} FAILED: {e}")
    print(f"crash_sweep: {len(points) - failures}/{len(points)} points "
          f"recovered cleanly (workdir {workdir})")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
