"""A plain model of the order in which K7 (csrc/arena_verify.cu), and so
K8's verify, spreads the speculation arena over K4's block body
(csrc/verify_x4.cuh), against the port's plain version
(``resident.arena_verify_plain``) and the JAX package's pure-Python
oracle ``tendermint_tpu.crypto.ed25519_ref.verify``, on the CPU.

The model is the kernel's digits role composed with the models of
the rest of the block (``test_torch_general_order``: the 4-thread
chain, the signed table, the comb split, for every comb-warp count):

- a lane is live when it is active and its s_ok holds;
- a block of TM_X4_LANES lanes with no live lane does no work and
  reads false (``__syncthreads_or``);
- in a working block the digits warp assembles each live lane's
  ``width`` sign bytes with K2's byte rule (``sign_bytes.cuh``
  ``tm_msg_byte``, modelled byte for byte below) into its row of the
  block's shared memory (TM_ARENA_ROW bytes a row), then hashes the row
  with nb = min(tm_msg_blocks(mlen), (64 + width) / 128) blocks, folds
  and recodes; a dead lane's digits are 0 and its verdict false.

The arena: two template groups of different lengths (the canonical
precommit template, whose messages take two SHA-512 blocks, and a short
one whose messages take one or two by their timestamp), inactive lanes
between active ones, active lanes whose S >= L, a block of 32 inactive
lanes, a block with one live lane, the adversarial kinds (undecodable
R, non-canonical R, small-order and undecodable keys), order-8 torsion
in A and in R, non-canonical keys. At width 64 the clamp on nb binds
for the lanes whose message needs two blocks. The JAX reference kernel
(``_arena_kernel``) is held to the plain version by
test_torch_resident.py. Tolerance: exact (bytes, verdicts)."""

import hashlib

import numpy as np
import pytest
import test_torch_general_order as go
import torch

from tendermint_tpu.crypto import ed25519_ref as jref
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import vectors
from tendermint_tpu_torch.crypto.cuda import expanded as ex
from tendermint_tpu_torch.crypto.cuda import resident
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.types import canonical
from tendermint_tpu_torch.types import sign_batch as sbm
from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
from tendermint_tpu_torch.types.vote import VoteType

LANES = 32       # TM_X4_LANES (common.cuh)
MAX_W = 192      # TM_ARENA_MAX_W (arena_verify.cu)
ROW = MAX_W + 4  # TM_ARENA_ROW: a lane's message row in shared memory
PATCH_W, PRE_W, SUF_W = resident.PATCH_W, resident.PRE_W, resident.SUF_W
# The short template: 30 + 10 bytes, so a message of 41-47 bytes (a
# timestamp of 0 or 1 ns, or 1 s) takes one SHA-512 block, 48 or more two.
SHORT = (bytes(range(1, 31)), b"\x32\x08order-k7")
EDGE_TS = (0, 1, 1_000_000_000, 999_999_999, (1 << 63) - 1)


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


# -- the digits role ----------------------------------------------------------


def msg_blocks(mlen: int) -> int:
    """sign_bytes.cuh tm_msg_blocks: SHA-512 blocks of R || A || M."""
    return (64 + mlen + 17 + 127) // 128


def msg_byte(pre_g, pl, suf_g, sl, prow, a, plen, j) -> int:
    """sign_bytes.cuh tm_msg_byte: byte j of a lane's padded message."""
    def clip(c, hi):
        return min(max(c, 0), hi)

    c1 = a + pl
    c2 = c1 + (plen - a)
    c3 = c2 + sl
    if j < a:
        v = prow[clip(j, PATCH_W - 1)]
    elif j < c1:
        v = pre_g[clip(j - a, PRE_W - 1)]
    elif j < c2:
        v = prow[clip(a + (j - c1), PATCH_W - 1)]
    elif j < c3:
        v = suf_g[clip(j - c2, SUF_W - 1)]
    else:
        v = 0
    if j == c3:
        v = 0x80
    nb = msg_blocks(c3)
    bitlen = (64 + c3) * 8
    k = 15 - (j - (nb * 128 - 16 - 64))
    if 0 <= k < 16:
        v = (bitlen >> (8 * k)) & 0xFF if k < 4 else 0
    return int(v)


def digits_role(largs, width: int):
    """Every block's digits warp: (live, working, reads, nb). live =
    active & s_ok; working marks the lanes of blocks with a live lane;
    reads (N, MAX_W) holds the MAX_W bytes of the block's rows from each
    live lane's row on, as the warp wrote them (its `width` bytes, then
    what the row leaves unwritten), of which SHA-512 reads the first
    nb * 128 - 64; nb is the lane's clamped block count (0 for the
    others)."""
    (_ab, _sb, s_ok, active, pre, pre_len, suf, suf_len, patch, split,
     patch_len, group, _btab) = (t.numpy() for t in largs)
    n = active.shape[0]
    live = active & s_ok
    maxb = (64 + width) // 128
    working = np.zeros(n, bool)
    reads = np.zeros((n, MAX_W), np.uint8)
    nb = np.zeros(n, np.int32)
    for b0 in range(0, n, LANES):
        if not live[b0:b0 + LANES].any():
            continue  # the block reads false and returns
        working[b0:b0 + LANES] = True
        rows = np.zeros(LANES * ROW, np.uint8)
        mine = [b0 + lane for lane in range(min(LANES, n - b0))
                if live[b0 + lane]]
        for i in mine:
            g = group[i]
            pl, sl = int(pre_len[g]), int(suf_len[g])
            a, plen = int(split[i]), int(patch_len[i])
            row = rows[(i - b0) * ROW:(i - b0) * ROW + width]
            for j in range(width):
                row[j] = msg_byte(pre[g], pl, suf[g], sl, patch[i], a, plen, j)
            nb[i] = min(msg_blocks(plen + pl + sl), maxb)
        for i in mine:
            reads[i] = rows[(i - b0) * ROW:(i - b0) * ROW + MAX_W]
    return live, working, reads, nb


def k7_model(largs, width: int) -> dict:
    """K7's verdicts for each comb-warp count: the digits role, then
    K4's block order (go.k4_model) over the working blocks' lanes."""
    live, working, reads, nb = digits_role(largs, width)
    ab, sb, btab = largs[0], largs[1], largs[12]
    idx = torch.from_numpy(working.nonzero()[0])
    models = go.k4_model(ab[idx], sb[idx], torch.from_numpy(reads)[idx],
                         torch.from_numpy(nb)[idx],
                         torch.from_numpy(live)[idx], btab)
    out = {}
    for c_warps, v in models.items():
        full = torch.zeros(ab.shape[0], dtype=torch.bool)
        full[idx] = v
        out[c_warps] = full
    return out


# -- the arena ----------------------------------------------------------------


def _sign_bytes(arena, group: int, ts: int):
    """A lane's patch, split, patch_len and sign bytes for (group, ts)."""
    patch, split, plen = sbm._build_patches(
        arena.pre_len.astype(np.int64), arena.suf_len,
        np.array([group], np.int32), np.array([ts], np.int64))
    a, pl = int(split[0]), int(plen[0])
    p = patch[0].tobytes()
    g = int(group)
    msg = (p[:a] + arena.pre[g, :arena.pre_len[g]].tobytes() + p[a:pl]
           + arena.suf[g, :arena.suf_len[g]].tobytes())
    return patch[0], a, pl, msg


def _build(width: int, seed: int):
    """A 128-lane arena (four blocks) and, by slot, each active lane's
    (pub, sign bytes, sig)."""
    rng = np.random.default_rng(seed)
    arena = resident.ResidentArena(32, width=width)
    assert arena.capacity == 4 * LANES
    bid = BlockID(bytes(range(32)), PartSetHeader(3, bytes(32)))
    arena.set_template(1, *canonical.vote_sign_parts(
        "arena-order", int(VoteType.PRECOMMIT), 977, 1, bid))
    arena.set_template(2, *SHORT)

    def ts_of(slot):
        return (EDGE_TS[slot % len(EDGE_TS)] if slot % 3 == 0
                else int(rng.integers(1, 1 << 62)))

    plan = {}  # slot -> (group, ts)
    if width == MAX_W:
        plan.update({s: (1, ts_of(s)) for s in range(1, 32) if s % 4})
        plan.update({s: (2, ts_of(s)) for s in (66, 70, 90)})
        plan.update({s: (2, ts_of(s)) for s in range(97, 117, 2)})
        plan.update({s: (1 + s % 2, ts_of(s)) for s in range(117, 128)})
    else:  # width 64: short messages only, one block or clamped
        plan.update({s: (2, ts_of(s)) for s in range(1, 128) if s % 5})
    signed = {s: _sign_bytes(arena, g, t) for s, (g, t) in plan.items()}
    slots = sorted(plan)
    adv = [s for s in slots if not 97 <= s < 117]
    b = vectors.adversarial_batch(8, len(adv), seed=seed,
                                  msgs=[signed[s][3] for s in adv])
    lanes = {s: (b["pubkeys"][k], m, sig) for s, k, m, sig in
             zip(adv, b["idx"], b["msgs"], b["sigs"])}
    if width == MAX_W:
        # block 2: one live lane (70); 66 and 90 active with S >= L
        pub, m, sig = lanes[70]
        key = next(k for k, kind in zip(b["idx"], b["kinds"])
                   if kind == "valid")
        seed_k = hashlib.sha256(b"adv-%d-%d" % (seed, key)).digest()
        lanes[70] = (b["pubkeys"][key], m, ref.sign(seed_k, m))
        for s in (66, 90):
            m = lanes[s][1]
            sig = ref.sign(seed_k, m)
            big = int.from_bytes(sig[32:], "little") + ref.L
            lanes[s] = (b["pubkeys"][key], m, sig[:32] + big.to_bytes(32, "little"))
        torsion = [s for s in slots if 97 <= s < 117]
        for s, (pub, m, sig, _good) in zip(
                torsion, go._torsion_lanes([signed[s][3] for s in torsion])):
            lanes[s] = (pub, m, sig)
    lanes = {s: t for s, t in lanes.items() if len(t[2]) == 64}
    filler = ref.public_key_from_seed(bytes(32))
    arena.install_keys([lanes[s][0] if s in lanes else filler
                        for s in range(1, arena.capacity)])
    spliced = sorted(lanes)
    arena.splice(spliced,
                 np.frombuffer(b"".join(lanes[s][2] for s in spliced),
                               np.uint8).reshape(-1, 64),
                 np.stack([signed[s][0] for s in spliced]),
                 [signed[s][1] for s in spliced],
                 [signed[s][2] for s in spliced],
                 [plan[s][0] for s in spliced])
    return arena, lanes


@pytest.fixture(scope="module")
def arena192():
    set_default_device("cpu")
    arena, lanes = _build(MAX_W, seed=41)
    largs = arena.launch_args()
    plain = resident.arena_verify_plain(*largs, width=MAX_W)
    set_default_device(None)
    return arena, lanes, largs, plain


def _oracle(arena, lanes) -> list[bool]:
    """The JAX package's oracle over each active lane's sign bytes (the
    sentinel's from the arena's own probe), false for the others."""
    out = [False] * arena.capacity
    out[0] = True  # the sentinel, checked below by the plain version
    for s, (pub, m, sig) in lanes.items():
        out[s] = jref.verify(pub, m, sig)
    return out


def test_message_rows_start_in_32_banks():
    assert ROW % 4 == 0 and (ROW // 4) % 2 == 1
    assert len({(lane * ROW // 4) % 32 for lane in range(LANES)}) == 32
    assert LANES * ROW == 6272  # K7's rows after K4's shared memory


def test_arena_holds_every_case(arena192):
    arena, lanes, largs, _plain = arena192
    live, working, _msg, nb = digits_role(largs, MAX_W)
    active = largs[3].numpy()
    blocks = [slice(b, b + LANES) for b in range(0, arena.capacity, LANES)]
    assert [int(live[b].sum()) for b in blocks][1:3] == [0, 1]
    assert not active[blocks[1]].any()  # 32 inactive lanes
    assert working.tolist() == [bool(live[b].any()) for b in blocks
                                for _ in range(LANES)]
    gaps = (~active[1:-1] & active[:-2] & active[2:]).nonzero()[0]
    assert len(gaps) > 3  # inactive lanes between active ones
    assert (active & ~live).sum() >= 3  # active, S >= L
    group = largs[11].numpy()
    assert {int(n) for n in nb[live & (group == 2)]} == {1, 2}
    assert {int(n) for n in nb[live & (group == 1)]} == {2}
    assert arena.pre_len[1] != arena.pre_len[2]
    assert arena.suf_len[1] != arena.suf_len[2]
    torsion = range(97, 117, 2)  # go._torsion_lanes, in order
    assert all(s in lanes for s in torsion)
    assert [lanes[s][0] in go.NONCANONICAL_KEYS for s in torsion] == \
        [False] * 6 + [True] * 4
    assert len({lanes[s][0] for s in torsion[:6]}) == 2  # aB, aB + T8
    assert any(sig[:32] == vectors.undecodable_encoding()
               for _pub, _m, sig in lanes.values())


def test_rows_equal_the_plain_assembly_and_the_signed_bytes(arena192):
    arena, lanes, largs, _plain = arena192
    live, _working, msg, nb = digits_role(largs, MAX_W)
    assert not msg[~live].any()  # a dead lane's row is not written
    idx = torch.from_numpy(live.nonzero()[0])
    want_msg, want_nb = ex.assemble_plain(
        *largs[4:8], largs[8][idx], largs[9][idx], largs[10][idx],
        largs[11][idx], MAX_W)
    assert np.array_equal(msg[idx.numpy()], want_msg.numpy())
    assert np.array_equal(nb[idx.numpy()], want_nb.numpy())
    for i in idx.tolist():
        if i in lanes:
            m = lanes[i][1]
            assert msg[i][:len(m)].tobytes() == m


def test_k7_order_verdicts_equal_plain_and_oracle(arena192):
    arena, lanes, largs, plain = arena192
    oracle = _oracle(arena, lanes)
    assert plain.tolist() == oracle
    assert any(oracle[1:]) and not all(oracle[1:])
    models = k7_model(largs, MAX_W)
    assert sorted(models) == list(go.COMB_WARPS)
    for c_warps, got in models.items():
        assert torch.equal(got, plain), c_warps


def test_k7_order_clamps_nb_at_width_64():
    """Width 64: one SHA-512 block a lane. The lanes whose message needs
    two are hashed over the first only (their 64 row bytes; the row's
    next 128 are not theirs), in the model and in the plain version
    alike, so a valid signature reads false; the others are the
    oracle's."""
    arena, lanes = _build(64, seed=43)
    largs = arena.launch_args()
    plain = resident.arena_verify_plain(*largs, width=64)
    live, _working, reads, nb = digits_role(largs, 64)
    idx = torch.from_numpy(live.nonzero()[0])
    msg64, _nblocks = ex.assemble_plain(
        *largs[4:8], largs[8][idx], largs[9][idx], largs[10][idx],
        largs[11][idx], 64)
    ab, sb = largs[0][idx], largs[1][idx]
    one = torch.ones(len(idx), dtype=torch.bool)
    assert torch.equal(
        go.k4_digits(ab, sb, torch.from_numpy(reads)[idx],
                     torch.from_numpy(nb)[idx], one),
        go.k4_digits(ab, sb, msg64, torch.ones(len(idx), dtype=torch.int32),
                     one))
    group, plen = largs[11].numpy(), largs[10].numpy()
    need = np.array([msg_blocks(int(p) + int(arena.pre_len[g])
                                + int(arena.suf_len[g]))
                     for p, g in zip(plen, group)])
    clamped = live & (need == 2)
    assert (live & (need == 1)).sum() > 3
    oracle = _oracle(arena, lanes)
    assert any(oracle[s] and not plain[s] for s in clamped.nonzero()[0])
    for s in range(arena.capacity):
        if not clamped[s]:
            assert bool(plain[s]) == oracle[s], s
    models = k7_model(largs, 64)
    for c_warps, got in models.items():
        assert torch.equal(got, plain), c_warps
