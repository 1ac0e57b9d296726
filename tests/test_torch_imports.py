"""The port stands alone: no module of tendermint_tpu_torch, and neither
chip_smoke.py nor sweep_warps.py, imports jax or anything of the JAX package; a CPU
verify_commit and a CPU sr25519 batch verify in a fresh interpreter
load neither."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "tendermint_tpu")


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted((ROOT / "tendermint_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "sweep_warps.py"]
    assert len(files) > 20
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {f"tendermint_tpu_torch/{m}.py" for m in (
        "crypto/merlin", "crypto/merlin_batch", "crypto/sr25519_ref",
        "crypto/cuda/fieldsel", "crypto/cuda/field_f32",
        "crypto/sr25519", "crypto/cuda/ristretto", "crypto/cuda/sr_verify",
        "types/evidence", "evidence/verify", "libs/__init__", "libs/clock",
        "libs/net", "libs/failpoints")} <= names
    bad = {str(f.relative_to(ROOT)): sorted(n for n in _imported(f)
                                             if _forbidden(n))
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


SCRIPT = r"""
import hashlib, sys
from tendermint_tpu_torch.device import set_default_device
set_default_device("cpu")
from tendermint_tpu_torch.crypto import ed25519, ed25519_ref
from tendermint_tpu_torch.types.block import (
    BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader)
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet
seeds = [hashlib.sha256(b"imp%d" % i).digest() for i in range(130)]
pubs = [ed25519_ref.public_key_from_seed(s) for s in seeds]
seed_of = dict(zip(pubs, seeds))
vs = ValidatorSet([Validator.new(ed25519.Ed25519PubKey(p), 1) for p in pubs])
bid = BlockID(b"\x01" * 32, PartSetHeader(1, b"\x02" * 32))
cs = [CommitSig(BlockIDFlag.COMMIT, v.address, 10**18 + i, b"")
      for i, v in enumerate(vs.validators)]
commit = Commit(9, 0, bid, cs)
for i, v in enumerate(vs.validators):
    p = v.pub_key.bytes()
    cs[i].signature = ed25519_ref.sign(seed_of[p], commit.vote_sign_bytes("c", i))
vs.verify_commit("c", bid, 9, commit)
from tendermint_tpu_torch.crypto import sr25519_ref, vectors
from tendermint_tpu_torch.crypto.cuda.sr_verify import verify_batch_sr
minis = [hashlib.sha256(b"imp-sr%d" % i).digest() for i in range(4)]
msgs = [b"sr %d" % i for i in range(4)]
sr_sigs = vectors.sr_sign_batch(minis, msgs)
sr_sigs[3] = sr_sigs[3][:63] + bytes([sr_sigs[3][63] & 0x7F])
got = verify_batch_sr([sr25519_ref.public_key_from_mini(m) for m in minis],
                      msgs, sr_sigs, device="cpu")
assert got.tolist() == [True, True, True, False], got
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "tendermint_tpu"))
print("LOADED", loaded)
assert not loaded, loaded
"""


def test_cpu_verify_commit_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout
