"""Port parity for the speculation arena (crypto/cuda/resident.py): K6's
splice and clear and K7's arena verify, by their plain PyTorch
versions on the CPU, against the JAX reference's ResidentArena (XLA
CPU backend; its _arena_kernel through launch), its verify_batch and
the ed25519_ref oracle, on numpy-seeded inputs. Tolerance: exact —
buffers byte-equal, verdicts bit-identical."""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.tpu import resident as jresident
from tendermint_tpu.crypto.tpu import verify as jtv
from tendermint_tpu_torch.crypto import batch as cbatch
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import vectors
from tendermint_tpu_torch.crypto.cuda import resident
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.types import sign_batch as sbm

BUFFERS = ("ab", "sb", "s_ok", "patch", "split", "patch_len", "group",
           "active")


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


def _rows(arena, ts, sigs):
    """Splice arguments (less the slots) for lanes with these
    timestamps and signatures, against the arena's group-1 template."""
    ts = np.asarray(ts, np.int64)
    group = np.ones(len(ts), np.int32)
    patch, split, patch_len = sbm._build_patches(
        arena.pre_len.astype(np.int64), arena.suf_len, group, ts)
    sig_rows = np.frombuffer(b"".join(sigs), np.uint8).reshape(-1, 64)
    return sig_rows, patch, split, patch_len, group


def _assert_same(jarena, parena):
    for name in BUFFERS:
        want = np.array(getattr(jarena, f"_{name}"))
        got = getattr(parena, f"_{name}").numpy()
        assert want.dtype == got.dtype and np.array_equal(want, got), name
    for name in ("pre", "pre_len", "suf", "suf_len"):
        assert np.array_equal(getattr(jarena, name), getattr(parena, name))


def test_splice_and_clear_sequence_matches_reference():
    """One sequence of splices and clears — duplicate slots, a delta at
    the arena's capacity, deactivate_all — through both arenas: after
    each step the buffers are equal, and no splice moves a buffer."""
    rng = np.random.default_rng(31)
    jarena, parena = jresident.ResidentArena(32), resident.ResidentArena(32)
    cap = parena.capacity
    assert cap == jarena.capacity == 128
    assert parena.arena_bytes() == jarena.arena_bytes()
    _assert_same(jarena, parena)
    pubs = [ref.public_key_from_seed(bytes([i]) * 32) for i in range(40)]
    pre, suf = b"\x08\x02\x11" + bytes(range(60)), b"\x32\x0bsome-chain"

    def sigs(k):
        return [rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
                for _ in range(k)]

    def ts(k):
        return rng.integers(0, 1 << 62, k).tolist()

    steps = []
    t = ts(3)
    steps.append(([1, 2, 3], t, sigs(3)))
    s4, t4 = sigs(1), ts(1)
    steps.append(([4, 5, 4], [t4[0], ts(1)[0], t4[0]],
                  [s4[0], sigs(1)[0], s4[0]]))
    steps.append("clear")
    full = list(range(1, cap)) + [9]  # capacity rows, slot 9 twice
    t_full, s_full = ts(cap - 1), sigs(cap - 1)
    steps.append((full, t_full + [t_full[8]], s_full + [s_full[8]]))
    steps.append(([cap - 1], ts(1), sigs(1)))
    steps.append("clear")
    steps.append(([7], [0], sigs(1)))
    for arena in (jarena, parena):
        arena.install_keys(pubs)
        arena.set_template(1, pre, suf)
    _assert_same(jarena, parena)
    ptrs = {name: parena.buffer_pointer(name) for name in BUFFERS}
    for step in steps:
        for arena in (jarena, parena):
            if step == "clear":
                arena.deactivate_all()
            else:
                slots, t, s = step
                arena.splice(slots, *_rows(arena, t, s))
        _assert_same(jarena, parena)
        assert {n: parena.buffer_pointer(n) for n in BUFFERS} == ptrs
    assert parena.active_lanes == int(np.array(jarena._active).sum()) == 2


def test_pack_delta_layout_round_trips():
    """K6's packed buffer unpacks (splice_plain) to the rows it packed,
    at ROW_BYTES a row."""
    rng = np.random.default_rng(32)
    k, n = 5, 16
    pos = np.array([3, 1, 15, 8, 2])
    sig = rng.integers(0, 256, (k, 64), dtype=np.uint8)
    patch = rng.integers(0, 256, (k, 24), dtype=np.uint8)
    s_ok = np.array([1, 0, 1, 1, 0], bool)
    ints = rng.integers(-2**31, 2**31, (3, k)).astype(np.int32)
    packed = resident.pack_delta(pos, sig, s_ok, patch, *ints)
    assert packed.dtype == np.uint8 and packed.shape == (k * resident.ROW_BYTES,)
    bufs = [torch.zeros((n, 64), dtype=torch.uint8),
            torch.zeros(n, dtype=torch.bool),
            torch.zeros((n, 24), dtype=torch.uint8),
            *(torch.zeros(n, dtype=torch.int32) for _ in range(3)),
            torch.zeros(n, dtype=torch.bool)]
    resident.splice_plain(*bufs, torch.from_numpy(packed))
    assert np.array_equal(bufs[0].numpy()[pos], sig)
    assert np.array_equal(bufs[1].numpy()[pos], s_ok)
    assert np.array_equal(bufs[2].numpy()[pos], patch)
    for j in range(3):
        assert np.array_equal(bufs[3 + j].numpy()[pos], ints[j])
    assert bufs[6].numpy().nonzero()[0].tolist() == sorted(pos.tolist())
    with pytest.raises(resident.kernels.KernelError, match="rows of 105"):
        resident.splice_plain(*bufs, torch.from_numpy(packed[:-1]))


@pytest.fixture(scope="module")
def loaded():
    """A 31-lane arena batch (every adversarial kind, 64-byte signatures
    spliced but every 9th, the rest inactive) in a port arena."""
    set_default_device("cpu")
    b = vectors.arena_batch(8, 31, seed=33)
    arena = resident.ResidentArena(32)
    pubs = [b["pubkeys"][k] for k in b["idx"]]
    arena.install_keys(pubs)
    arena.set_template(1, b["pre"], b["suf"])
    keep = [i for i, s in enumerate(b["sigs"]) if len(s) == 64 and i % 9 != 4]
    arena.splice([i + 1 for i in keep],
                 *_rows(arena, [b["ts"][i] for i in keep],
                        [b["sigs"][i] for i in keep]))
    out = resident.arena_verify_plain(*arena.launch_args()).numpy()
    set_default_device(None)
    return b, pubs, keep, arena, out


def test_arena_verify_plain_matches_reference_and_oracle(loaded):
    b, pubs, keep, arena, out = loaded
    assert out.shape == (arena.capacity,)
    assert bool(out[0]), "the sentinel lane must verify"
    inactive = np.ones(arena.capacity, bool)
    inactive[0] = False
    inactive[[i + 1 for i in keep]] = False
    assert not out[inactive].any()
    assert inactive[1:32].sum() == 31 - len(keep) > 0
    got = out[[i + 1 for i in keep]].tolist()
    msgs = [b["msgs"][i] for i in keep]
    args = ([pubs[i] for i in keep], msgs, [b["sigs"][i] for i in keep])
    assert got == jtv.verify_batch(*args).tolist()
    assert got == [ref.verify(*t) for t in zip(*args)]
    assert got == b["expect"][keep].tolist()
    kinds = {b["kinds"][i] for i in keep}
    assert {"valid", "bad_sig", "s_ge_l", "undecodable_r",
            "small_order_key", "undecodable_key"} <= kinds
    # the sign bytes K7 assembles are the canonical ones
    spub, smsg, ssig = cbatch._ed_probe_triple()
    assert ref.verify(spub, smsg, ssig)


def test_arena_verify_plain_matches_reference_kernel(loaded):
    """The reference's _arena_kernel (its ResidentArena.launch, on the
    XLA CPU backend) over the same arena: every lane's verdict, the
    sentinel's and the inactive lanes' included, is the plain
    version's."""
    b, pubs, keep, arena, out = loaded
    jarena = jresident.ResidentArena(32)
    jarena.install_keys(pubs)
    jarena.set_template(1, b["pre"], b["suf"])
    jarena.splice([i + 1 for i in keep],
                  *_rows(jarena, [b["ts"][i] for i in keep],
                         [b["sigs"][i] for i in keep]))
    _assert_same(jarena, arena)
    assert np.array_equal(np.asarray(jarena.launch()), out)


def test_arena_wrappers_take_plain_version_for_cpu_tensors(loaded):
    """CPU tensors run the plain versions; no kernel launch is counted."""
    _b, _pubs, _keep, arena, out = loaded
    before = (resident.splice.launches, resident.clear.launches,
              resident.arena_verify.launches)
    assert np.array_equal(resident.arena_verify(*arena.launch_args()).numpy(),
                          out)
    active = arena._active.clone()
    resident.clear(active)
    assert active.nonzero()[:, 0].tolist() == [0]
    assert (resident.splice.launches, resident.clear.launches,
            resident.arena_verify.launches) == before


def test_arena_width_and_slot_guards():
    with pytest.raises(ValueError, match="width"):
        resident.ResidentArena(8, width=100)
    arena = resident.ResidentArena(8)
    assert arena.capacity == 128 and arena.active_lanes == 1
    with pytest.raises(AssertionError, match="sentinel"):
        arena.splice([0], np.zeros((1, 64), np.uint8),
                      np.zeros((1, 24), np.uint8), [1], [1], [1])
