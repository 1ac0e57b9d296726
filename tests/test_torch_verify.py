"""Port parity: the general kernel's plain version (K4) and verify_batch
against the JAX reference's verify_batch and the ed25519_ref oracle,
on one numpy-seeded adversarial batch, on the CPU. Tolerance: exact —
verdicts bit-identical; host packing byte-identical."""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.tpu import verify as jtv
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import vectors
from tendermint_tpu_torch.crypto.batch import BatchVerifier, _DEVICE_THRESHOLD
from tendermint_tpu_torch.crypto.cuda import verify as tv
from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey
from tendermint_tpu_torch.device import set_default_device


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


@pytest.fixture(scope="module")
def batch():
    b = vectors.adversarial_batch(16, 88, seed=21)
    b["pubs"] = [b["pubkeys"][k] for k in b["idx"]]
    return b


def test_verify_batch_matches_reference_and_oracle(batch):
    args = (batch["pubs"], batch["msgs"], batch["sigs"])
    got = tv.verify_batch(*args)
    assert got.tolist() == jtv.verify_batch(*args).tolist()
    assert got.tolist() == [ref.verify(*t) for t in zip(*args)]
    assert got.tolist() == batch["expect"].tolist()
    assert set(batch["kinds"]) == set(vectors.KINDS)


def test_general_verify_plain_on_packed_lanes(batch):
    keep = [i for i, s in enumerate(batch["sigs"]) if len(s) == 64]
    packed = tv.pack_batch([batch["pubs"][i] for i in keep],
                           [batch["msgs"][i] for i in keep],
                           [batch["sigs"][i] for i in keep])
    jpacked = jtv.pack_batch([batch["pubs"][i] for i in keep],
                             [batch["msgs"][i] for i in keep],
                             [batch["sigs"][i] for i in keep])
    for k in ("ab", "sb", "msg", "nblocks", "s_ok"):
        assert np.array_equal(packed[k], jpacked[k]), k
    t = tv.to_device(packed, "cpu")
    out = tv.general_verify(t["ab"], t["sb"], t["msg"], t["nblocks"],
                            t["s_ok"], tv._btab("cpu"))
    assert out.tolist() == [bool(batch["expect"][i]) for i in keep]


def test_b_comb_tables_match_reference():
    assert np.array_equal(tv.b_comb_tables(),
                          tv.b_comb_from_reference(jtv.b_comb_tables()))


def test_s_range_ok_and_chunks_match_reference():
    rng = np.random.default_rng(22)
    rows = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    for i, s in enumerate([ref.L - 1, ref.L, ref.L + 1, 0, 2**256 - 1]):
        rows[i, 32:] = np.frombuffer(s.to_bytes(32, "little"), np.uint8)
    assert np.array_equal(tv.s_range_ok(rows), jtv.s_range_ok(rows))
    assert tv.s_range_ok(rows)[:5].tolist() == [True, False, False, True, False]
    for n in (1, 127, 128, 129, 10_240, 40_000, 70_000):
        assert tv._chunks(n) == jtv._chunks(n)


def test_batch_verifier_routes_like_reference(batch, monkeypatch):
    """Below _DEVICE_THRESHOLD lanes stay on the host; at and above it
    they go to the general kernel — with the same verdicts."""
    calls = []
    real = tv.verify_batch
    monkeypatch.setattr(tv, "verify_batch",
                        lambda *a, **k: calls.append(len(a[0])) or real(*a, **k))
    for n in (_DEVICE_THRESHOLD - 1, _DEVICE_THRESHOLD):
        bv = BatchVerifier()
        for p, m, s in zip(batch["pubs"][2:2 + n], batch["msgs"][2:2 + n],
                           batch["sigs"][2:2 + n]):
            bv.add(Ed25519PubKey(p), m, s)
        ok, lanes = bv.verify()
        assert lanes.tolist() == batch["expect"][2:2 + n].tolist()
        assert ok == bool(batch["expect"][2:2 + n].all())
    assert calls == [_DEVICE_THRESHOLD]


def test_wrapper_takes_plain_version_only_for_cpu_tensors(batch):
    """A CPU tensor runs the plain version; the kernel path is chosen by
    the tensor's device, never by a fallback."""
    before = tv.general_verify.launches
    t = tv.to_device(tv.pack_batch(batch["pubs"][2:4], batch["msgs"][2:4],
                                   [batch["sigs"][2]] * 2), "cpu")
    tv.general_verify(t["ab"], t["sb"], t["msg"], t["nblocks"], t["s_ok"],
                      tv._btab("cpu"))
    assert tv.general_verify.launches == before
    assert isinstance(tv.general_verify(
        t["ab"], t["sb"], t["msg"], t["nblocks"], t["s_ok"],
        tv._btab("cpu")), torch.Tensor)
