"""Port parity under TM_TPU_FIELD=f32: the slice's path on the f32
field, in a child process (the field is chosen once, at import) with
TM_TPU_FIELD=f32 and JAX_PLATFORMS=cpu, against the reference's f32
build and against the port's own i32 build in this process.

- The port's verify_batch (the plain K4 on float32 limbs) and the
  reference's verify.verify_batch (its general kernel traced under f32
  on the XLA CPU backend) give the same verdicts, lane for lane, on
  crypto/vectors.py's adversarial ZIP-215 batch.
- verify_commit on a 130-validator all-ed25519 set takes the expanded
  route (plain K1, K2, K3 on f32 tables) and gives the i32 build's
  outcome, and its rejection index for a corrupted signature.
- K1's f32 tables equal the i32 tables on canonical values, key for
  key, and its key flags are equal.
- A 16-lane sr25519 batch beside ed25519 lanes, through a
  BatchVerifier (the plain K9 under f32), agrees with the host oracle.

A second child with TM_TPU_FIELD=bogus must raise ValueError, with the
reference's text, in both packages. Tolerance: exact everywhere. The
child's failure fails the tests; nothing is skipped on the CPU."""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
N_VALS = 130
BAD = 77  # the corrupted slot of the commit

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import test_torch_f32_path as T
print(json.dumps(T.report(with_reference=True)))
"""

BOGUS = r"""
import importlib, json
out = {}
for name in ("tendermint_tpu.crypto.tpu.edwards",
             "tendermint_tpu_torch.crypto.cuda.edwards"):
    try:
        importlib.import_module(name)
    except ValueError as e:
        out[name] = str(e)
print(json.dumps(out))
"""


def _run(script: str, field: str, *args) -> dict:
    env = dict(os.environ, TM_TPU_FIELD=field, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", script, *args], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _commit():
    """A 130-validator ed25519 set (ValidatorSet sorts by address) and a
    commit every validator signs."""
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.types.block import (
        BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader)
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    seeds = [hashlib.sha256(b"f32-val-%d" % i).digest() for i in range(N_VALS)]
    seed_of = {ref.public_key_from_seed(s): s for s in seeds}
    vs = ValidatorSet([Validator.new(ed25519.Ed25519PubKey(p), 10)
                       for p in seed_of])
    bid = BlockID(b"\x0f" * 32, PartSetHeader(2, b"\x0e" * 32))
    cs = [CommitSig(BlockIDFlag.COMMIT, v.address, 10**18 + 7 * i, b"")
          for i, v in enumerate(vs.validators)]
    commit = Commit(41, 0, bid, cs)
    for i, v in enumerate(vs.validators):
        cs[i].signature = ref.sign(seed_of[v.pub_key.bytes()],
                                   commit.vote_sign_bytes("f32-chain", i))
    return vs, bid, commit


def _commit_outcome() -> dict:
    """verify_commit on the valid commit, then with BAD corrupted: the
    route, the outcomes and the cached tables' layout."""
    from tendermint_tpu_torch.crypto.cuda import expanded
    from tendermint_tpu_torch.types.validator_set import VerificationError

    vs, bid, commit = _commit()
    out = {"expanded": vs._use_expanded(list(range(N_VALS)))}
    vs.verify_commit("f32-chain", bid, 41, commit)
    good = commit.signatures[BAD].signature
    commit.signatures[BAD].signature = good[:9] + bytes([good[9] ^ 2]) + good[10:]
    try:
        vs.verify_commit("f32-chain", bid, 41, commit)
    except VerificationError as e:
        out["rejected"] = str(e)
    exp = expanded.get_expanded([v.pub_key.bytes() for v in vs.validators])
    out["tables"] = [str(exp.tables.dtype), list(exp.tables.shape)]
    return out


def _k1_canonical() -> dict:
    """K1 (plain) on the adversarial batch's first four keys (one
    undecodable, one of small order): key flags and a digest of every
    table entry's canonical values."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto import vectors
    from tendermint_tpu_torch.crypto.cuda import expanded
    from tendermint_tpu_torch.crypto.cuda.fieldsel import F as fe

    keys = vectors.adversarial_batch(4, 8, seed=11)["pubkeys"][:4]
    akeys = torch.from_numpy(
        np.frombuffer(b"".join(keys), np.uint8).reshape(-1, 32).copy())
    tables, ok = expanded.build_tables_plain(akeys)
    vals = fe.from_limbs(fe.canonical(
        tables.reshape(-1, fe.NLIMB).T.to(fe.DTYPE)))
    return {"ok": ok.tolist(), "canonical_sha": hashlib.sha256(
        b"".join(v.to_bytes(32, "little") for v in vals)).hexdigest()}


def _sr_mixed() -> dict:
    """A BatchVerifier over 16 sr25519 adversarial lanes (the first with
    a 32-byte key, which a key object needs) and 4 ed25519 lanes: the
    sr25519 group runs verify_batch_sr (the plain K9); the verdicts
    against sr25519_ref.verify and ed25519_ref.verify."""
    from tendermint_tpu_torch.crypto import ed25519, sr25519, vectors
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto import sr25519_ref as sr
    from tendermint_tpu_torch.crypto.batch import BatchVerifier
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv

    b = vectors.sr_adversarial_batch(32, seed=7)
    keep = [i for i, p in enumerate(b["pubs"]) if len(p) == 32][:16]
    b = {k: [b[k][i] for i in keep] for k in ("pubs", "msgs", "sigs")}
    seeds = [hashlib.sha256(b"f32-ed-%d" % i).digest() for i in range(4)]
    ed = [(ref.public_key_from_seed(s), b"ed lane %d" % i)
          for i, s in enumerate(seeds)]
    ed_sigs = [ref.sign(s, m) for s, (_, m) in zip(seeds, ed)]
    ed_sigs[2] = ed_sigs[2][:5] + bytes([ed_sigs[2][5] ^ 1]) + ed_sigs[2][6:]
    calls = []
    real = sv.verify_batch_sr
    sv.verify_batch_sr = lambda p, *a, **k: calls.append(len(p)) or real(
        p, *a, **k)
    try:
        bv = BatchVerifier()
        for p, m, s in zip(b["pubs"], b["msgs"], b["sigs"]):
            bv.add(sr25519.Sr25519PubKey(p), m, s)
        for (p, m), s in zip(ed, ed_sigs):
            bv.add(ed25519.Ed25519PubKey(p), m, s)
        lanes = bv.verify()[1].tolist()
    finally:
        sv.verify_batch_sr = real
    oracle = [sr.verify(p, m, s) for p, m, s in zip(b["pubs"], b["msgs"],
                                                     b["sigs"])]
    oracle += [ref.verify(p, m, s) for (p, m), s in zip(ed, ed_sigs)]
    return {"lanes": lanes, "oracle": oracle, "sr_calls": calls}


def report(with_reference: bool) -> dict:
    """Everything the tests compare, from the port on the CPU (and from
    the reference's general kernel when with_reference) in this
    process's field."""
    import torch

    from tendermint_tpu_torch.crypto import vectors
    from tendermint_tpu_torch.crypto.cuda import kernels
    from tendermint_tpu_torch.crypto.cuda import verify as ptv
    from tendermint_tpu_torch.crypto.cuda.fieldsel import CHOICE, F
    from tendermint_tpu_torch.device import set_default_device

    set_default_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {"field": CHOICE, "nlimb": F.NLIMB, "kernels_field": kernels.FIELD,
               "commit": _commit_outcome(), "k1": _k1_canonical()}
        if with_reference:
            from tendermint_tpu.crypto.tpu import verify as jtv

            b = vectors.adversarial_batch(16, 120, seed=3)
            pubs = [b["pubkeys"][k] for k in b["idx"]]
            out["k4"] = {
                "port": ptv.verify_batch(pubs, b["msgs"], b["sigs"]).tolist(),
                "ref": jtv.verify_batch(pubs, b["msgs"],
                                        b["sigs"]).tolist(),
                "expect": b["expect"].tolist()}
            out["sr"] = _sr_mixed()
        return out
    finally:
        torch.set_num_threads(threads)
        set_default_device(None)


@pytest.fixture(scope="module")
def f32():
    return _run(CHILD, "f32", str(ROOT / "tests"))


@pytest.fixture(scope="module")
def i32():
    from tendermint_tpu_torch.crypto.cuda import fieldsel

    assert fieldsel.CHOICE == "i32"
    return report(with_reference=False)


def test_child_runs_the_f32_field(f32):
    assert (f32["field"], f32["nlimb"], f32["kernels_field"]) == (
        "f32", 32, "f32")


def test_general_kernel_matches_reference_f32_lane_for_lane(f32):
    k4 = f32["k4"]
    assert k4["port"] == k4["ref"] == k4["expect"]
    assert not all(k4["port"]) and any(k4["port"])


def test_verify_commit_matches_i32_outcome_and_rejection(f32, i32):
    assert f32["commit"]["expanded"] and i32["commit"]["expanded"]
    assert f32["commit"]["rejected"] == i32["commit"]["rejected"] == (
        f"invalid signature(s) at index(es) [{BAD}]")
    assert f32["commit"]["tables"] == ["torch.float32", [N_VALS, 69, 9, 4, 32]]
    assert i32["commit"]["tables"] == ["torch.int32", [N_VALS, 69, 9, 4, 10]]


def test_comb_tables_match_i32_on_canonical_values(f32, i32):
    assert f32["k1"] == i32["k1"]
    assert f32["k1"]["ok"] == [False, True, True, True]


def test_sr25519_batch_matches_oracle_under_f32(f32):
    sr = f32["sr"]
    assert sr["lanes"] == sr["oracle"] and sr["sr_calls"] == [16]
    assert not all(sr["lanes"][:16]) and any(sr["lanes"][:16])


def test_bogus_field_raises_in_both_packages():
    got = _run(BOGUS, "bogus")
    want = "TM_TPU_FIELD='bogus': expected 'i32' or 'f32'"
    assert got == {"tendermint_tpu.crypto.tpu.edwards": want,
                   "tendermint_tpu_torch.crypto.cuda.edwards": want}
