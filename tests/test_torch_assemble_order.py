"""K2 inside K3/K5's structured launch (csrc/xverify.cu), on the CPU.

K2 has no launch of its own: in the structured form of K3 and K5 the
hashing warp builds its block's 32 message rows in shared memory and
hashes them from there, as the reference traces ``assemble_core`` into
``_skernel``. A plain model of that assembly, in the kernel's order, is
held byte for byte to the port's plain version
(``expanded.assemble_plain``) and to the JAX package's
``assemble_core`` jitted on the XLA CPU backend:

- thread l of warp 0 (the hashing warp) writes bytes 0, 1, ... of its
  lane's row in turn, by K2's byte rule (``sign_bytes.cuh``
  ``tm_msg_byte``, modelled in test_torch_arena_order.py); the other
  warps write no row (spreading the rows over them was measured slower
  on the card);
- a row lies at TM_XV_ROW bytes a row in the block's buffer, and a dead
  lane's row (s_ok or key_ok false, or a pad lane past n) is written by
  no thread.

The model writes every byte of every live row exactly once, and
nothing else. Then ``ExpandedKeys.verify_structured`` on CPU tensors:
one K3 call in the structured form, no message tensor and no K2 entry,
its verdicts those of the JAX package's pure-Python oracle on the
reference's own sign bytes, a lane whose patch is off by one byte
included (the reference's ``ExpandedKeys.verify_structured`` is held to
the port on the same kind of commit by test_torch_expanded.py; this
file compiles no reference kernel). Tolerance: exact."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_arena_order as ao
import torch

from tendermint_tpu.crypto import ed25519_ref as jref
from tendermint_tpu.crypto.tpu import expanded as jex
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types.sign_batch import CommitSignBatch as JCommitSignBatch
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto.cuda import expanded as ex
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types.sign_batch import CommitSignBatch

LANES = 32             # TM_XV_LANES (common.cuh)
MAX_W = 448            # TM_XV_MAX_W (xverify.cu)
ROW = MAX_W + 4        # TM_XV_ROW: a row's stride in the block's buffer
PATCH_W, PRE_W, SUF_W = 24, 128, 64
GROUPS = 32            # ExpandedKeys._S_GROUPS
CHAIN = "assemble-order"


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


def block_assembly(fields: dict, live: np.ndarray, width: int):
    """The structured form's assembly as the kernel orders it, block by
    block: returns every block's shared buffer (n_blocks, 32 * ROW) and
    how many times each of its bytes was written."""
    n = live.shape[0]
    n_blocks = -(-n // LANES)
    smem = np.zeros((n_blocks, LANES * ROW), np.uint8)
    writes = np.zeros((n_blocks, LANES * ROW), np.int64)
    for blk in range(n_blocks):
        for lane in range(LANES):  # thread `lane` of the hashing warp
            i = blk * LANES + lane
            if i >= n or not live[i]:  # a pad or dead lane: no row
                continue
            g = int(fields["group"][i])
            args = (fields["pre"][g], int(fields["pre_len"][g]),
                    fields["suf"][g], int(fields["suf_len"][g]),
                    fields["patch"][i], int(fields["split"][i]),
                    int(fields["patch_len"][i]))
            for j in range(width):
                smem[blk, lane * ROW + j] = ao.msg_byte(*args, j)
                writes[blk, lane * ROW + j] += 1
    return smem, writes


def _fields(rng, n: int, width: int) -> dict:
    """n lanes over GROUPS template groups of different lengths, each
    message fitting `width` (mlen <= width - 17); splits at 0, at the
    patch length and between."""
    pre_len = rng.integers(0, PRE_W + 1, GROUPS).astype(np.int32)
    suf_len = rng.integers(0, SUF_W + 1, GROUPS).astype(np.int32)
    pre_len[:3] = (0, PRE_W, 7)
    suf_len[:3] = (SUF_W, 0, 1)
    pre = np.zeros((GROUPS, PRE_W), np.uint8)
    suf = np.zeros((GROUPS, SUF_W), np.uint8)
    for g in range(GROUPS):
        pre[g, :pre_len[g]] = rng.integers(1, 256, pre_len[g])
        suf[g, :suf_len[g]] = rng.integers(1, 256, suf_len[g])
    group = np.zeros(n, np.int32)
    patch_len = np.zeros(n, np.int32)
    split = np.zeros(n, np.int32)
    for i in range(n):
        while True:
            g = int(rng.integers(0, GROUPS))
            plen = int(rng.integers(0, PATCH_W + 1))
            if plen + pre_len[g] + suf_len[g] <= width - 17:
                break
        group[i], patch_len[i] = g, plen
        split[i] = (0, plen, int(rng.integers(0, plen + 1)))[i % 3]
    patch = rng.integers(0, 256, (n, PATCH_W)).astype(np.uint8)
    return dict(pre=pre, pre_len=pre_len, suf=suf, suf_len=suf_len,
                patch=patch, split=split, patch_len=patch_len, group=group)


ORDER = ("pre", "pre_len", "suf", "suf_len", "patch", "split", "patch_len",
         "group")


@pytest.mark.parametrize("width,alive", [(192, 0.8), (448, 0.8), (192, 1.0),
                                         (448, 0.0)])
def test_block_assembly_equals_plain_and_reference(width, alive):
    """Every live row of the model equals assemble_plain's and the
    reference's assemble_core's, byte for byte; each of its bytes is
    written once, and nothing else in a block's buffer is written (dead
    lanes, pad lanes of the last block, the bytes between width and the
    row stride)."""
    rng = np.random.default_rng(width + int(10 * alive))
    n = 77  # three blocks, the last with 19 pad lanes
    f = _fields(rng, n, width)
    live = rng.random(n) < alive
    live[32:64] = False  # a whole dead block
    live[65] = True
    smem, writes = block_assembly(f, live, width)
    msg, nblocks = ex.assemble_plain(
        *(torch.from_numpy(f[k]) for k in ORDER), width)
    jmsg, jnb = jax.jit(jex.assemble_core(), static_argnums=8)(
        *(jnp.asarray(f[k]) for k in ORDER), width)
    assert np.array_equal(msg.numpy(), np.asarray(jmsg))
    assert np.array_equal(nblocks.numpy(), np.asarray(jnb))
    want = np.zeros_like(writes)
    for i in np.flatnonzero(live):
        blk, r = divmod(int(i), LANES)
        row = smem[blk, r * ROW:r * ROW + width]
        assert np.array_equal(row, msg.numpy()[i]), i
        want[blk, r * ROW:r * ROW + width] = 1
        # the hashing warp's block count: tm_msg_blocks(mlen)
        g = f["group"][i]
        mlen = f["patch_len"][i] + f["pre_len"][g] + f["suf_len"][g]
        assert ao.msg_blocks(int(mlen)) == nblocks[i]
    assert np.array_equal(writes, want)


def test_rows_fit_the_buffer_and_start_in_32_banks():
    """TM_XV_ROW is an odd number of words at least the widest width, and
    the 32 rows fit the dynamic buffer the tree's points take anyway in
    the i32 build (20,480 B at 8 warps)."""
    assert ROW % 4 == 0 and (ROW // 4) % 2 == 1 and ROW >= max(
        ex.ExpandedKeys._S_WIDTHS)
    assert len({(r * ROW // 4) % 32 for r in range(LANES)}) == 32
    # TM_XV_POINT_BYTES: W / 2 partial points a lane, 4 x 10 int32 limbs
    assert LANES * ROW <= (8 // 2) * LANES * 4 * 10 * 4


def _commit(n: int):
    """The same commit in both packages, lane i signed by key i, mixed
    for-block and nil votes, edge timestamps."""
    edge = [0, 1, 999_999_999, 1_000_000_000, 1_753_928_000_123_456_789]
    seeds = [hashlib.sha256(b"ao%d" % i).digest() for i in range(n)]
    pubs = [ref.public_key_from_seed(s) for s in seeds]
    made = []
    for mod in (pblock, jblock):
        bid = mod.BlockID(bytes(range(32)), mod.PartSetHeader(2, bytes(32)))
        sigs = [mod.CommitSig(mod.BlockIDFlag.NIL if i % 5 == 2
                              else mod.BlockIDFlag.COMMIT,
                              bytes([i]) * 20, edge[i % 5] + i, b"")
                for i in range(n)]
        made.append(mod.Commit(31, 0, bid, sigs))
    pc, jc = made
    sigs = [ref.sign(seeds[i], pc.vote_sign_bytes(CHAIN, i)) for i in range(n)]
    for i in range(n):
        pc.signatures[i].signature = jc.signatures[i].signature = sigs[i]
    return pubs, pc, jc, sigs


def test_verify_structured_is_one_structured_k3_call(monkeypatch):
    """verify_structured on CPU tensors makes one K3 call, in the
    structured form (templates and patches, no message tensor), and no
    K2 entry exists; its verdicts equal the JAX package's oracle on the
    reference's sign bytes, the lane whose patch is off by one byte
    (and so whose assembled bytes are not the signed ones) rejected."""
    n, off = 40, 13
    pubs, pc, jc, sigs = _commit(n)
    lanes = list(range(n))
    psb = CommitSignBatch(CHAIN, pc, lanes)
    jsb = JCommitSignBatch(CHAIN, jc, lanes)
    for sb in (psb, jsb):
        sb.patch[off, 0] ^= 1  # the lane's outer length prefix
    keys = ex.ExpandedKeys(pubs)
    calls = []
    real = ex.xverify

    def spy(*a, **kw):
        calls.append({k: kw.get(k) is not None
                      for k in ("msg", "templates", "patches")})
        return real(*a, **kw)

    monkeypatch.setattr(ex, "xverify", spy)
    got = keys.verify_structured(lanes, psb, sigs)
    assert calls == [{"msg": False, "templates": True, "patches": True}]
    assert not hasattr(ex, "assemble")
    want = [jref.verify(pubs[i], jsb.host_assemble(i), sigs[i])
            for i in lanes]
    assert want[off] is False and sum(want) == n - 1
    assert got.tolist() == want
