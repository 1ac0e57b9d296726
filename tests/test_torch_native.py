"""The port's C message packer (tendermint_tpu_torch/native/pack.c)
against the JAX package's pad_messages.

On the same seeded messages the port's C path (256 messages or more),
its numpy path (forced with lib() None) and the reference's
crypto/tpu/sha512.py pad_messages give equal bytes and equal int32
block counts, at 255, 256, 700 and 10,240 messages, with the
reference's lengths and a 64- and a 0-byte prefix. With no library the
port falls back to numpy at the same point as the reference
(tests/test_native.py). The library is built under build/native/,
never beside the reference's tendermint_tpu/native/."""

import random
from pathlib import Path

import numpy as np
import pytest

from tendermint_tpu.crypto.tpu import sha512 as ref_sh
from tendermint_tpu_torch import native
from tendermint_tpu_torch.crypto.cuda import sha512 as sh

ROOT = Path(__file__).resolve().parents[1]
LENGTHS = (0, 1, 40, 63, 64, 65, 111, 127, 200, 500, 2000)


def messages(n: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    lens = rng.choice(LENGTHS, size=n)
    return [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
            for k in lens]


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)  # lib() -> None


def test_the_library_builds_under_build_not_beside_the_reference():
    L = native.lib()
    assert L is not None, "cc is on this machine: the library must build"
    so = Path(L._name).resolve()
    assert so == native.so_path().resolve()
    assert so.is_relative_to(ROOT / "build" / "native")
    assert not so.is_relative_to(ROOT / "tendermint_tpu")
    assert not list((ROOT / "tendermint_tpu_torch" / "native").glob("*.so"))


@pytest.mark.parametrize("prefix", [64, 0])
@pytest.mark.parametrize("n", [255, 256, 700, 10_240])
def test_c_numpy_and_reference_paths_agree(n, prefix, monkeypatch):
    assert native.lib() is not None
    msgs = messages(n, seed=n + prefix)
    got, got_nb = sh.pad_messages(msgs, prefix_len=prefix)
    want, want_nb = ref_sh.pad_messages(msgs, prefix_len=prefix)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    plain, plain_nb = sh.pad_messages(msgs, prefix_len=prefix)
    for nb in (got_nb, want_nb, plain_nb):
        assert nb.dtype == np.int32 and nb.shape == (n,)
    assert got.dtype == np.uint8 and got.shape == want.shape == plain.shape
    assert np.array_equal(got, want) and np.array_equal(plain, want)
    assert np.array_equal(got_nb, want_nb)
    assert np.array_equal(plain_nb, want_nb)


def test_the_c_path_is_taken_from_256_messages(monkeypatch):
    calls = []
    L = native.lib()

    class Spy:
        def tm_pack_pad(self, *a):
            calls.append(a[3])
            return L.tm_pack_pad(*a)

    monkeypatch.setattr(native, "_lib", Spy())
    sh.pad_messages(messages(255, 1), prefix_len=64)
    assert calls == []
    sh.pad_messages(messages(256, 1), prefix_len=64)
    assert calls == [256]


def test_numpy_fallback_when_native_missing(no_native):
    """The reference's tests/test_native.py fallback case, on the port."""
    msgs = [b"m%03d" % i for i in range(300)]
    out, nb = sh.pad_messages(msgs, prefix_len=64)
    assert out.shape[0] == 300 and (nb == 1).all()
    assert out[0, 4] == 0x80
    want, want_nb = ref_sh.pad_messages(msgs, prefix_len=64)
    assert np.array_equal(out, want) and np.array_equal(nb, want_nb)


def test_a_failed_build_falls_back_and_logs(monkeypatch, caplog, tmp_path):
    """A compiler that fails: lib() is None, the reference's warning is
    logged, and pad_messages still pads (numpy)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "native")
    bad_cc = tmp_path / "cc"
    bad_cc.write_text("#!/bin/sh\nexit 1\n")
    bad_cc.chmod(0o755)
    monkeypatch.setattr(native.shutil, "which",
                        lambda name: str(bad_cc))
    with caplog.at_level("WARNING", logger="native"):
        assert native.lib() is None
    assert "native build failed" in caplog.text
    assert not list((tmp_path / "native").rglob("*.so"))
    random.seed(3)
    msgs = [bytes(random.randrange(256) for _ in range(70))
            for _ in range(300)]
    out, nb = sh.pad_messages(msgs, prefix_len=64)
    want, want_nb = ref_sh.pad_messages(msgs, prefix_len=64)
    assert np.array_equal(out, want) and np.array_equal(nb, want_nb)


def test_the_packed_rows_feed_pack_sig_msg(monkeypatch):
    """verify.pack_sig_msg over the C path: the same dict as over the
    numpy path (message rows bucketed to a power-of-two block count)."""
    from tendermint_tpu_torch.crypto.cuda import verify

    assert native.lib() is not None
    msgs = messages(512, 7)
    sig = np.random.default_rng(7).integers(0, 256, (512, 64), np.uint8)
    c = verify.pack_sig_msg(sig, msgs)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    plain = verify.pack_sig_msg(sig, msgs)
    assert c.keys() == plain.keys()
    for k in c:
        assert np.array_equal(c[k], plain[k]), k
