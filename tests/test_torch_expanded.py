"""Port parity: expanded validator sets (K1 table build, K2 sign-bytes
assembly, which runs inside K3's structured launch, K3 verify) against
the JAX reference on the CPU.

The port runs its plain PyTorch versions (set_default_device("cpu")),
the reference its jitted programs on the XLA CPU backend, both on one
numpy-seeded adversarial batch of 128 keys. Tolerance: exact — table
entries equal mod p coordinate by coordinate, sign bytes identical,
verdicts bit-identical."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.tpu import expanded as jex
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types.sign_batch import CommitSignBatch as JCommitSignBatch
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import vectors
from tendermint_tpu_torch.crypto.cuda import expanded as ex
from tendermint_tpu_torch.crypto.cuda import field as fe
from tendermint_tpu_torch.crypto.cuda import verify as tv
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types.sign_batch import CommitSignBatch

N_KEYS = 128
CHAIN = "torch-parity"


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


@pytest.fixture(scope="module")
def batch():
    return vectors.adversarial_batch(N_KEYS, 96, seed=11)


@pytest.fixture(scope="module")
def ref_keys(batch):
    return jex.ExpandedKeys(batch["pubkeys"])


@pytest.fixture(scope="module")
def port_keys(batch):
    set_default_device("cpu")
    try:
        return ex.ExpandedKeys(batch["pubkeys"])
    finally:
        set_default_device(None)


def test_build_tables_match_reference_mod_p(ref_keys, port_keys):
    ref_tab = np.asarray(ref_keys.tables)  # (V*69*9, 128) reference rows
    conv = fe.from_radix12(ref_tab[:, :88].reshape(N_KEYS, 69, 9, 4, 22))
    ours = port_keys.tables.reshape(-1, 10).T.to(torch.int64)
    canon = fe.canonical(ours).T.reshape(conv.shape).numpy()
    assert np.array_equal(canon, conv)
    assert port_keys.key_ok.tolist() == np.asarray(ref_keys.key_ok).tolist()
    assert port_keys.key_ok.tolist()[:2] == [False, True]
    # spot entries by Python integers, independent of the converter
    for v, w, j, c in [(2, 0, 1, 0), (5, 68, 8, 3), (127, 33, 4, 1), (1, 7, 2, 2)]:
        row = ref_tab[(v * 69 + w) * 9 + j, 22 * c:22 * (c + 1)]
        want = sum(int(x) << (12 * i) for i, x in enumerate(row)) % fe.P
        got = fe.from_limbs(port_keys.tables[v, w, j, c].to(torch.int64)) % fe.P
        assert got == want


def test_from_reference_arrays_round_trip(batch, ref_keys, port_keys):
    carried = ex.ExpandedKeys.from_reference_arrays(
        batch["pubkeys"], np.asarray(ref_keys.tables), np.asarray(ref_keys.key_ok))
    a = fe.canonical(carried.tables.reshape(-1, 10).T.to(torch.int64))
    b = fe.canonical(port_keys.tables.reshape(-1, 10).T.to(torch.int64))
    assert torch.equal(a, b)
    assert torch.equal(carried.key_ok, port_keys.key_ok)
    lanes = list(range(2, 2 + 40))
    msgs = [b"carried %d" % i for i in lanes]
    seeds = [hashlib.sha256(b"adv-11-%d" % i).digest() for i in lanes]
    sigs = [ref.sign(s, m) for s, m in zip(seeds, msgs)]
    sigs[3] = sigs[3][:40] + b"\0" + sigs[3][41:]
    got = carried.verify(lanes, msgs, sigs)
    assert got.tolist() == port_keys.verify(lanes, msgs, sigs).tolist()
    assert got.tolist() == [i != 3 for i in range(40)]


def _structured_commit(n: int, tamper: dict):
    """The same commit in both packages: mixed for-block and nil votes,
    edge timestamps, lane i signed by key i (some lanes tampered)."""
    edge = [0, 1, 999_999_999, 1_000_000_000, 1_753_928_000_123_456_789]
    seeds = [hashlib.sha256(b"sc%d" % i).digest() for i in range(n)]
    pubs = [ref.public_key_from_seed(s) for s in seeds]
    made = []
    for mod in (pblock, jblock):
        bid = mod.BlockID(bytes(range(32)), mod.PartSetHeader(2, bytes(32)))
        sigs = [mod.CommitSig(mod.BlockIDFlag.NIL if i % 7 == 3
                              else mod.BlockIDFlag.COMMIT,
                              bytes([i]) * 20, edge[i % 5] + i, b"")
                for i in range(n)]
        made.append(mod.Commit(977, 1, bid, sigs))
    pc, jc = made
    out = []
    for i in range(n):
        msg = pc.vote_sign_bytes(CHAIN, i)
        assert msg == jc.vote_sign_bytes(CHAIN, i)
        kind = tamper.get(i)
        sig = ref.sign(seeds[(i + 1) % n] if kind == "wrong-lane"
                       else seeds[i], msg)
        if kind == "ts":
            pc.signatures[i].timestamp += 1
            jc.signatures[i].timestamp += 1
        elif kind == "malformed":
            sig = b"\x07" * 63
        elif kind == "s_ge_l":
            s = int.from_bytes(sig[32:], "little") + ref.L
            sig = sig[:32] + s.to_bytes(32, "little")
        pc.signatures[i].signature = jc.signatures[i].signature = sig
        out.append(sig)
    return pubs, pc, jc, out


def test_assemble_matches_reference_bytes():
    pubs, pc, jc, sigs = _structured_commit(40, {})
    lanes = list(range(40))
    psb = CommitSignBatch(CHAIN, pc, lanes)
    jsb = JCommitSignBatch(CHAIN, jc, lanes)
    keys = ex.ExpandedKeys.__new__(ex.ExpandedKeys)
    keys.pubkeys = tuple(pubs)
    _idx, fields, _wf, width = keys._prepare_structured(lanes, psb, sigs)
    order = ("pre", "pre_len", "suf", "suf_len", "patch", "split",
             "patch_len", "group")
    for name in order:  # the host templates and patches agree too
        assert np.array_equal(getattr(psb, name), getattr(jsb, name))
    t = {k: torch.from_numpy(np.require(v, requirements=["C", "W"]))
         for k, v in fields.items()}
    msg, nblocks = ex.assemble_plain(*(t[k] for k in order), width)
    jmsg, jnb = jex.assemble_core()(*(jnp.asarray(fields[k]) for k in order),
                                    width)
    assert np.array_equal(msg.numpy(), np.asarray(jmsg))
    assert np.array_equal(nblocks.numpy(), np.asarray(jnb))
    host = tv.pack_sig_msg(fields["sb"][:40], psb.materialize())
    hw = host["msg"].shape[1]
    assert np.array_equal(msg.numpy()[:40, :hw], host["msg"])
    assert not msg.numpy()[:40, hw:].any()


def test_verify_adversarial_lanes_match_reference(batch, ref_keys, port_keys):
    args = (batch["idx"], batch["msgs"], batch["sigs"])
    got = port_keys.verify(*args)
    assert got.tolist() == ref_keys.verify(*args).tolist()
    assert got.tolist() == batch["expect"].tolist()
    oracle = [ref.verify(batch["pubkeys"][k], m, s) for k, m, s in zip(*args)]
    assert got.tolist() == oracle


def test_verify_structured_matches_reference():
    tamper = {5: "ts", 11: "wrong-lane", 17: "malformed", 23: "s_ge_l"}
    pubs, pc, jc, sigs = _structured_commit(48, tamper)
    lanes = list(range(48))
    port = ex.ExpandedKeys(pubs)
    ref_exp = jex.ExpandedKeys(pubs)
    got = port.verify_structured(lanes, CommitSignBatch(CHAIN, pc, lanes), sigs)
    want = ref_exp.verify_structured(lanes, JCommitSignBatch(CHAIN, jc, lanes),
                                     sigs)
    assert got.tolist() == want.tolist()
    assert got.tolist() == [i not in tamper for i in lanes]
    # the bytes path gives the same verdicts
    msgs = CommitSignBatch(CHAIN, pc, lanes).materialize()
    assert port.verify(lanes, msgs, sigs).tolist() == got.tolist()


def test_structured_limits_raise_value_error_like_reference():
    pubs, pc, jc, sigs = _structured_commit(8, {})
    lanes = list(range(8))
    keys = ex.ExpandedKeys.__new__(ex.ExpandedKeys)
    keys.pubkeys = tuple(pubs)
    psb = CommitSignBatch(CHAIN, pc, lanes)
    psb.patch[0, 0] ^= 1  # lane-0 self-check must fire
    with pytest.raises(ValueError, match="self-check"):
        keys._prepare_structured(lanes, psb, sigs)


def test_bucket_and_max_keys():
    assert [ex.ExpandedKeys._bucket(n) for n in (1, 128, 129, 1024, 1025, 10240)] \
        == [128, 128, 256, 1024, 2048, 10240]
    assert ex.max_keys() == jex._CPU_MAX_KEYS
    assert ex.TABLE_BYTES_PER_KEY == 99_360


def test_entry_points_raise_without_gpu(monkeypatch):
    set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.ExpandedKeys([ref.public_key_from_seed(b"\1" * 32)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.verify_batch([b"\0" * 32], [b""], [b"\0" * 64])


def test_warm_async_builds_and_reraises(monkeypatch):
    """The warm thread leaves the set in get_expanded's cache, and its
    join() raises what a failed build raised (exact exception type)."""
    keys = [ref.public_key_from_seed(b"warm%d" % i) for i in range(3)]
    ex.warm_async(keys).join()
    monkeypatch.setattr(ex, "ExpandedKeys", None)  # no second build
    assert ex.get_expanded(keys).key_ok.tolist() == [True] * 3
    set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = ex.warm_async(keys[:2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t.join()
