"""The rest of the port's failpoints (tendermint_tpu_torch/libs/
failpoints.py and libs/fail.py) held against the JAX package's on the
same inputs: the `every=` and `prob=` triggers (prob under one
`random.seed`), the TM_TPU_FAILPOINTS variable (parsed once, leniently),
the legacy FAIL_TEST_INDEX ordinal and its libs/fail.py shim, and the
`crash` action, run in a child process of each package whose exit code,
output and crash log are compared. Tolerance: exact — the same fires,
hit and fire counters, armed specs, errors, exit codes and lines."""

from __future__ import annotations

import os
import random
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from tendermint_tpu.libs import failpoints as jfp
from tendermint_tpu_torch.libs import failpoints as pfp

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"port": pfp, "reference": jfp}


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS.values():
        p.reset()
    yield
    for p in PKGS.values():
        p.reset()


def test_catalog_and_pipeline_equal_the_reference():
    assert set(pfp.CATALOG) == set(jfp.BY_NAME)
    for name, d in jfp.BY_NAME.items():
        assert pfp.BY_NAME[name].payload == d.payload == pfp.CATALOG[name]
        assert pfp.BY_NAME[name].legacy_index == d.legacy_index
    assert pfp.COMMIT_PIPELINE == jfp.COMMIT_PIPELINE
    assert pfp.ACTIONS == jfp.ACTIONS and pfp.ENV_VAR == jfp.ENV_VAR
    assert pfp.LEGACY_ENV_VAR == jfp.LEGACY_ENV_VAR


def _run(p, seed: int, spec: dict, hits: int, payload: bool):
    """Arm one point by `spec`, hit it `hits` times; each hit's outcome
    and the state() counters."""
    name = "p2p.send" if payload else "db.set"
    p.arm(name, **spec)
    random.seed(seed)
    out = []
    for i in range(hits):
        try:
            got = p.hit(name, payload=b"payload-%d" % i if payload else None)
            out.append(("ok", got))
        except p.FailpointError as e:
            out.append(("error", e.name))
    st = p.state()[name]
    return out, st["armed"], st["hits"], st["fires"], p.any_armed()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_every_and_prob_triggers_fire_alike(seed):
    rng = np.random.default_rng(seed)
    specs = [
        dict(action="error", every=int(rng.integers(1, 5))),
        dict(action="error", prob=float(np.round(rng.uniform(0.1, 0.9), 2))),
        dict(action="error", every=2, prob=0.5),
        dict(action="error", every=3, count=2),
        dict(action="corrupt", prob=0.3),
        dict(action="corrupt", every=2, count=3),
        dict(action="error", nth=4, prob=1.0),
        dict(action="error", prob=0.0),
    ]
    for spec in specs:
        payload = spec["action"] == "corrupt"
        got = {k: _run(p, seed, spec, 17, payload) for k, p in PKGS.items()}
        assert got["port"] == got["reference"], spec
        for p in PKGS.values():
            p.reset()


def test_bad_triggers_are_refused_alike():
    for kw in (dict(every=0), dict(prob=-0.1), dict(prob=1.5),
               dict(nth=0), dict(count=0), dict(delay_ms=61_000.0)):
        errs = []
        for p in PKGS.values():
            with pytest.raises(ValueError) as e:
                p.arm("wal.fsync", "delay" if "delay_ms" in kw else "error",
                      **kw)
            errs.append(str(e.value))
        assert errs[0] == errs[1], kw
    for spec in ("wal.fsync=crash:1", "wal.fsync=error;every", "x=error",
                 "wal.fsync=error;prob=abc", "wal.fsync"):
        errs = []
        for p in PKGS.values():
            with pytest.raises(ValueError) as e:
                p.validate_spec(spec)
            errs.append(str(e.value))
        assert errs[0] == errs[1], spec
    spec = "wal.fsync=crash;every=3,db.set=delay:5;prob=0.25;count=2"
    assert pfp.parse_spec(spec) == jfp.parse_spec(spec)
    for p in PKGS.values():
        p.validate_spec(spec)


def test_the_environment_spec_is_parsed_once_and_leniently(monkeypatch):
    monkeypatch.setenv(
        "TM_TPU_FAILPOINTS",
        "wal.fsync=error;nth=1, bogus.point=error, db.set=oops, "
        "db.set=error;every=2, p2p.send=corrupt;prob=1")
    got = {}
    for k, p in PKGS.items():
        p.reset()
        out = []
        for name in ("wal.fsync", "wal.fsync", "db.set", "db.set",
                     "p2p.send"):
            try:
                out.append(p.hit(name, payload=b"abc"
                                 if name == "p2p.send" else None))
            except p.FailpointError as e:
                out.append(e.name)
        # parsed once: a changed variable is not read again ...
        os.environ["TM_TPU_FAILPOINTS"] = "privval.save=error"
        out.append(p.hit("privval.save"))
        out.append(p.any_armed())
        # ... until reset()
        p.reset()
        with pytest.raises(p.FailpointError):
            p.hit("privval.save")
        os.environ["TM_TPU_FAILPOINTS"] = (
            "wal.fsync=error;nth=1, bogus.point=error, db.set=oops, "
            "db.set=error;every=2, p2p.send=corrupt;prob=1")
        got[k] = out
    assert got["port"] == got["reference"]
    assert got["port"][:5] == ["wal.fsync", None, None, "db.set", b"ac"]
    assert got["port"][-1] == ["db.set", "p2p.send", "wal.fsync"]


def test_fail_test_index_counts_the_crash_sites_alike(monkeypatch):
    from tendermint_tpu.libs import fail as jfail
    from tendermint_tpu_torch.libs import fail as pfail

    sites = sorted(pfp.CRASH_SITES) + ["wal.fsync", "db.set"]
    got = {}
    for k, (p, f) in {"port": (pfp, pfail),
                      "reference": (jfp, jfail)}.items():
        exits = []
        monkeypatch.setattr(p.os, "_exit", lambda code: exits.append(code))
        out = []
        for index in ("0", "2", "5", "7", "junk", "-1"):
            monkeypatch.setenv("FAIL_TEST_INDEX", index)
            f.reset()
            for i, name in enumerate(sites * 2):
                p.hit(name)
                out.append((index, i, list(exits)))
            f.fail()
            out.append((index, "fail", list(exits)))
            exits.clear()
        got[k] = out
    assert got["port"] == got["reference"]
    assert ("0", 0, [1]) in got["port"]


CHILD = textwrap.dedent('''
    import logging, os, sys
    logging.basicConfig(level=logging.WARNING,
                        format="%(levelname)s %(name)s: %(message)s")
    pkg = sys.argv[1]
    fp = __import__(pkg + ".libs.failpoints", fromlist=["x"])
    fail = __import__(pkg + ".libs.fail", fromlist=["x"])
    for i in range(int(sys.argv[2])):
        for name in ("consensus.commit.block_saved",
                     "consensus.commit.wal_delimited",
                     "state.apply.block_executed",
                     "state.apply.responses_saved",
                     "state.apply.app_committed",
                     "state.apply.state_saved"):
            print("hit", i, name, flush=True)
            fp.hit(name)
        fail.fail()
    print("survived", flush=True)
''')


@pytest.mark.parametrize("env", [
    {"TM_TPU_FAILPOINTS": "state.apply.app_committed=crash;nth=2"},
    {"TM_TPU_FAILPOINTS": "state.apply.block_executed=crash;every=3"},
    {"TM_TPU_FAILPOINTS": "consensus.commit.block_saved=crash;prob=0"},
    {"FAIL_TEST_INDEX": "9"},
    {"FAIL_TEST_INDEX": "6"},
])
def test_the_crash_action_in_a_child_exits_as_the_reference(env):
    """The crash action and the legacy ordinal end the child by
    os._exit(1) at the same hit, after the same crash log line."""
    got = {}
    for pkg in ("tendermint_tpu_torch", "tendermint_tpu"):
        penv = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
        penv.pop("TM_TPU_FAILPOINTS", None)
        penv.pop("FAIL_TEST_INDEX", None)
        penv.update(env)
        res = subprocess.run([sys.executable, "-c", CHILD, pkg, "4"],
                             cwd=str(ROOT), env=penv, capture_output=True,
                             text=True, timeout=120)
        log = [line for line in res.stderr.splitlines()
               if line.startswith("WARNING failpoints")]
        got[pkg] = (res.returncode, res.stdout, log)
    assert got["tendermint_tpu_torch"] == got["tendermint_tpu"]
    rc, out, log = got["tendermint_tpu_torch"]
    if "prob=0" in env.get("TM_TPU_FAILPOINTS", ""):
        assert rc == 0 and out.endswith("survived\n")
    else:
        assert rc == 1 and "survived" not in out
    if "TM_TPU_FAILPOINTS" in env and rc:
        assert log[-1].startswith("WARNING failpoints: failpoint firing: ")
        assert log[-1].endswith("action=crash")
