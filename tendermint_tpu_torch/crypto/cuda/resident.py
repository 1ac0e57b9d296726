"""ResidentArena: the speculation plane's per-lane verify buffers, kept
on the GPU across launches, and its two kernels.

In consensus the inputs of commit verification barely change between
launches: the pubkeys are the validator set, and between two
speculative launches of one height only the lanes whose precommits just
arrived differ. The arena therefore keeps every per-lane input on the
device:

    ab (N, 32)  pubkey rows        — uploaded once per valset change
    sb (N, 64)  signature rows     ┐
    patch/split/patch_len/group    │ spliced per arrival: one packed
    s_ok, active                   ┘ upload, one K6 launch, in place

``splice()`` ships only the delta rows (the timestamp patches and
signatures of newly arrived votes, 105 B a row, in ONE packed buffer)
and writes them into the resident buffers in place — the PyTorch form
of the reference's donated jit: a splice leaves every buffer's
``data_ptr()`` as it was. ``launch()`` then verifies every active lane
in one K7 launch, which assembles each lane's sign bytes from the
height's template and its patch (K2's byte rule) and runs the general
verify body (K4's) on the lane's resident key bytes, so no comb tables
are needed.

Lane 0 is a permanent known-answer sentinel (the breaker probe's
triple, ``crypto.batch._ed_probe_triple``); template group 0 holds its
message. A launch whose sentinel reads false did not verify.

Kernels (csrc/), each beside its plain PyTorch version:

- K6 ``splice`` and ``clear`` (csrc/splice.cu): reference
  tendermint_tpu/crypto/tpu/resident.py ``_splice_fn``, ``_clear_fn``.
- K7 ``arena_verify`` (csrc/arena_verify.cu): reference
  ``_arena_kernel``.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors (or raises KernelError).
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import default_device
from ...types.sign_batch import PATCH_W
from .. import batch as cbatch
from . import expanded as ex
from . import kernels
from . import verify as tv

# Template rows per arena (group 0 = sentinel); widths match the
# structured-path guards of expanded.py: every legal canonical vote fits.
GROUPS = 8
PRE_W = 128
SUF_W = 64
WIDTH = 192  # message-buffer width after the 64-byte R||A prefix
# One packed delta row: pos, split, patch_len, group (int32), the
# signature, the patch and s_ok — in that section order (csrc/splice.cu).
ROW_BYTES = 4 * 4 + 64 + PATCH_W + 1


# -- K6: splice and clear ------------------------------------------------


def pack_delta(pos, sig_rows, s_ok, patch, split, patch_len,
               group) -> np.ndarray:
    """k delta rows as ONE (k * ROW_BYTES,) uint8 buffer in K6's
    section layout: int32 pos, split, patch_len, group; then the (k, 64)
    signatures, the (k, 24) patches and the (k,) s_ok flags."""
    ints = np.stack([np.asarray(a, np.int32).reshape(-1) for a in
                     (pos, split, patch_len, group)])
    return np.concatenate([
        ints.reshape(-1).view(np.uint8),
        np.asarray(sig_rows, np.uint8).reshape(-1),
        np.asarray(patch, np.uint8).reshape(-1),
        np.asarray(s_ok, np.uint8).reshape(-1)])


def _delta_rows(packed: torch.Tensor) -> int:
    k, rem = divmod(packed.numel(), ROW_BYTES)
    if rem or packed.dtype != torch.uint8 or packed.dim() != 1:
        raise kernels.KernelError(
            f"packed delta: {tuple(packed.shape)} {packed.dtype} is not "
            f"k rows of {ROW_BYTES} bytes")
    return k


def splice_plain(sb, s_ok, patch, split, patch_len, group, active,
                 packed) -> None:
    """Plain PyTorch version of K6's splice (csrc/splice.cu): unpack
    the delta rows and write them into the buffers in place."""
    k = _delta_rows(packed)
    ints = packed[:16 * k].view(torch.int32).reshape(4, k)
    rest = packed[16 * k:]
    pos = ints[0].to(torch.int64)
    sb[pos] = rest[:64 * k].reshape(k, 64)
    patch[pos] = rest[64 * k:(64 + PATCH_W) * k].reshape(k, PATCH_W)
    s_ok[pos] = rest[(64 + PATCH_W) * k:].to(torch.bool)
    split[pos] = ints[1]
    patch_len[pos] = ints[2]
    group[pos] = ints[3]
    active[pos] = True


def splice(sb, s_ok, patch, split, patch_len, group, active,
           packed) -> None:
    """K6 wrapper: scatter the packed delta rows into the seven resident
    buffers in place — the plain version for CPU tensors, one launch of
    the CUDA kernel for CUDA tensors (or KernelError)."""
    if sb.device.type == "cpu":
        splice_plain(sb, s_ok, patch, split, patch_len, group, active,
                     packed)
        return
    dev = sb.device
    n = sb.shape[0]
    k = _delta_rows(packed)
    kernels.require(packed, "packed", torch.uint8, (k * ROW_BYTES,), dev)
    kernels.require(sb, "sb", torch.uint8, (n, 64), dev)
    kernels.require(s_ok, "s_ok", torch.bool, (n,), dev)
    kernels.require(patch, "patch", torch.uint8, (n, PATCH_W), dev)
    for name, t in (("split", split), ("patch_len", patch_len),
                    ("group", group)):
        kernels.require(t, name, torch.int32, (n,), dev)
    kernels.require(active, "active", torch.bool, (n,), dev)
    rc = kernels.lib().tm_splice(
        packed.data_ptr(), k, n, sb.data_ptr(), s_ok.data_ptr(),
        patch.data_ptr(), split.data_ptr(), patch_len.data_ptr(),
        group.data_ptr(), active.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(rc, "splice")
    splice.launches += 1


splice.launches = 0


def clear_plain(active) -> None:
    """Plain PyTorch version of K6's clear: every lane inactive but the
    sentinel lane 0, in place."""
    active.zero_()
    active[0] = True


def clear(active) -> None:
    """K6 clear wrapper: plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (or KernelError)."""
    if active.device.type == "cpu":
        clear_plain(active)
        return
    dev = active.device
    n = active.shape[0]
    kernels.require(active, "active", torch.bool, (n,), dev)
    rc = kernels.lib().tm_clear(active.data_ptr(), n,
                                kernels.stream_ptr(dev))
    kernels.check(rc, "clear")
    clear.launches += 1


clear.launches = 0


# -- K7: verify the active lanes -----------------------------------------


def arena_verify_plain(ab, sb, s_ok, active, pre, pre_len, suf, suf_len,
                       patch, split, patch_len, group, btab,
                       width: int = WIDTH) -> torch.Tensor:
    """Plain PyTorch version of K7 (csrc/arena_verify.cu): K2's assembly
    then K4's verify (expanded.assemble_plain, verify.
    general_verify_plain) over the active lanes; (N,) bool verdicts,
    false for every inactive lane."""
    out = torch.zeros(ab.shape[0], dtype=torch.bool, device=ab.device)
    live = active.nonzero()[:, 0]
    if live.numel():
        msg, nblocks = ex.assemble_plain(
            pre, pre_len, suf, suf_len, patch[live], split[live],
            patch_len[live], group[live], width)
        out[live] = tv.general_verify_plain(ab[live], sb[live], msg,
                                            nblocks, s_ok[live], btab)
    return out


def arena_verify(ab, sb, s_ok, active, pre, pre_len, suf, suf_len, patch,
                 split, patch_len, group, btab,
                 width: int = WIDTH) -> torch.Tensor:
    """K7 wrapper: plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (or KernelError)."""
    if ab.device.type == "cpu":
        return arena_verify_plain(ab, sb, s_ok, active, pre, pre_len, suf,
                                  suf_len, patch, split, patch_len, group,
                                  btab, width)
    dev = ab.device
    n = ab.shape[0]
    g = pre.shape[0]
    if width > WIDTH or (64 + width) % 128:
        raise kernels.KernelError(f"arena_verify: width {width}")
    kernels.require(ab, "ab", torch.uint8, (n, 32), dev)
    kernels.require(sb, "sb", torch.uint8, (n, 64), dev)
    kernels.require(s_ok, "s_ok", torch.bool, (n,), dev)
    kernels.require(active, "active", torch.bool, (n,), dev)
    kernels.require(pre, "pre", torch.uint8, (g, PRE_W), dev)
    kernels.require(pre_len, "pre_len", torch.int32, (g,), dev)
    kernels.require(suf, "suf", torch.uint8, (g, SUF_W), dev)
    kernels.require(suf_len, "suf_len", torch.int32, (g,), dev)
    kernels.require(patch, "patch", torch.uint8, (n, PATCH_W), dev)
    for name, t in (("split", split), ("patch_len", patch_len),
                    ("group", group)):
        kernels.require(t, name, torch.int32, (n,), dev)
    kernels.require(btab, "btab", torch.int32, tuple(tv.b_comb_tables().shape),
                    dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    rc = kernels.lib().tm_arena_verify(
        ab.data_ptr(), sb.data_ptr(), s_ok.data_ptr(), active.data_ptr(),
        pre.data_ptr(), pre_len.data_ptr(), suf.data_ptr(),
        suf_len.data_ptr(), patch.data_ptr(), split.data_ptr(),
        patch_len.data_ptr(), group.data_ptr(), btab.data_ptr(), n, width,
        out.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(rc, "arena_verify")
    arena_verify.launches += 1
    return out


arena_verify.launches = 0


# -- the arena -----------------------------------------------------------


class ResidentArena:
    """Fixed-capacity device-resident lane buffers (slot 0 sentinel)."""

    def __init__(self, lanes: int, width: int = WIDTH, device=None):
        if width > WIDTH or (64 + width) % 128:
            raise ValueError(f"arena width {width}")
        self.device = (default_device() if device is None
                       else torch.device(device))
        self.width = width
        self.capacity = ex.ExpandedKeys._bucket(max(lanes, 2))
        n = self.capacity
        spub, smsg, ssig = cbatch._ed_probe_triple()
        assert len(smsg) <= PRE_W
        ab = np.zeros((n, 32), np.uint8)
        sb = np.zeros((n, 64), np.uint8)
        ab[0] = np.frombuffer(spub, np.uint8)
        sb[0] = np.frombuffer(ssig, np.uint8)
        active = np.zeros(n, bool)
        active[0] = True

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        self._ab = dev(ab)
        self._sb = dev(sb)
        self._s_ok = dev(tv.s_range_ok(sb))
        self._patch = dev(np.zeros((n, PATCH_W), np.uint8))
        self._split = dev(np.zeros(n, np.int32))
        self._patch_len = dev(np.zeros(n, np.int32))
        self._group = dev(np.zeros(n, np.int32))
        self._active = dev(active.copy())
        # host-side template staging; uploaded at the next launch after
        # a change (set_template drops the device copy)
        self.pre = np.zeros((GROUPS, PRE_W), np.uint8)
        self.pre_len = np.zeros(GROUPS, np.int32)
        self.suf = np.zeros((GROUPS, SUF_W), np.uint8)
        self.suf_len = np.zeros(GROUPS, np.int32)
        self.pre[0, :len(smsg)] = np.frombuffer(smsg, np.uint8)
        self.pre_len[0] = len(smsg)
        self._templates = None
        self._btab = tv._btab(self.device)
        # host mirror of `active` (the kernels never read it back)
        self._live = active
        self.reupload_bytes = 0

    # -- sizes ----------------------------------------------------------

    def arena_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self._ab, *self.buffers()))

    @property
    def active_lanes(self) -> int:
        """Active lanes, the sentinel included."""
        return int(self._live.sum())

    # -- slow-path installs (valset / height changes) -------------------

    def install_keys(self, pubkeys: list[bytes], start: int = 1) -> None:
        """Upload pubkey rows for slots start..start+len-1 — once per
        validator-set change, not per launch."""
        assert start >= 1, "slot 0 is the sentinel"
        assert start + len(pubkeys) <= self.capacity
        assert all(len(p) == 32 for p in pubkeys)
        rows = np.frombuffer(b"".join(pubkeys), np.uint8).reshape(-1, 32)
        self._ab[start:start + len(pubkeys)].copy_(
            torch.from_numpy(rows.copy()))

    def set_template(self, group: int, pre: bytes, suf: bytes) -> None:
        """Stage a (pre, suf) template row (group 0 is the sentinel's)."""
        assert 1 <= group < GROUPS
        assert len(pre) <= PRE_W and len(suf) <= SUF_W
        self.pre[group] = 0
        self.suf[group] = 0
        self.pre[group, :len(pre)] = np.frombuffer(pre, np.uint8)
        self.suf[group, :len(suf)] = np.frombuffer(suf, np.uint8)
        self.pre_len[group] = len(pre)
        self.suf_len[group] = len(suf)
        self._templates = None

    def deactivate_all(self) -> None:
        """New height: every lane but the sentinel goes inactive (one K6
        clear); the buffers stay resident for the next splices."""
        clear(self._active)
        self._live[:] = False
        self._live[0] = True

    # -- the steady-state hot path --------------------------------------

    def buffers(self) -> tuple:
        """The seven buffers a splice writes, in K6's argument order:
        sb, s_ok, patch, split, patch_len, group, active."""
        return (self._sb, self._s_ok, self._patch, self._split,
                self._patch_len, self._group, self._active)

    def pack(self, slots, sig_rows: np.ndarray, patch: np.ndarray,
             split: np.ndarray, patch_len: np.ndarray,
             group: np.ndarray) -> np.ndarray:
        """The packed delta buffer (pack_delta) of these lanes, one row
        per slot: a slot given twice keeps its last row, as the
        reference's scatter does."""
        k = len(slots)
        pos = np.asarray(slots, np.int64)
        assert pos.min() >= 1 and pos.max() < self.capacity, \
            "slot 0 is the sentinel; slots must fit the arena"
        rows = [np.asarray(sig_rows, np.uint8).reshape(k, 64),
                np.asarray(patch, np.uint8).reshape(k, PATCH_W),
                np.asarray(split, np.int32).reshape(k),
                np.asarray(patch_len, np.int32).reshape(k),
                np.asarray(group, np.int32).reshape(k)]
        last = k - 1 - np.unique(pos[::-1], return_index=True)[1]
        if len(last) < k:
            pos = pos[last]
            rows = [a[last] for a in rows]
        sig_rows, patch, split, patch_len, group = rows
        return pack_delta(pos, sig_rows, tv.s_range_ok(sig_rows), patch,
                          split, patch_len, group)

    def splice(self, slots, sig_rows: np.ndarray, patch: np.ndarray,
               split: np.ndarray, patch_len: np.ndarray,
               group: np.ndarray) -> None:
        """Splice newly arrived lanes into the resident buffers: ONE
        upload of their packed rows (105 B each) and one K6 launch."""
        if len(slots) == 0:
            return
        packed = self.pack(slots, sig_rows, patch, split, patch_len, group)
        self.reupload_bytes += packed.nbytes
        self._live[np.asarray(slots, np.int64)] = True
        splice(*self.buffers(), torch.from_numpy(packed).to(self.device))

    def launch_args(self) -> tuple:
        """K7's arguments over the resident buffers (the templates
        uploaded first if they changed)."""
        if self._templates is None:
            host = (self.pre, self.pre_len, self.suf, self.suf_len)
            self._templates = tuple(torch.from_numpy(a.copy()).to(self.device)
                                    for a in host)
            self.reupload_bytes += sum(a.nbytes for a in host)
        pre, pre_len, suf, suf_len = self._templates
        return (self._ab, self._sb, self._s_ok, self._active, pre, pre_len,
                suf, suf_len, self._patch, self._split, self._patch_len,
                self._group, self._btab)

    def launch(self) -> np.ndarray:
        """Verify every active lane (sentinel included) in one K7
        launch. Returns (capacity,) verdicts — inactive lanes read
        False; callers check verdict[0] (the sentinel) before trusting
        the rest."""
        return arena_verify(*self.launch_args(), width=self.width).cpu().numpy()

    def buffer_pointer(self, name: str = "sb") -> int:
        """data_ptr() of a resident buffer: a splice leaves it as it
        was (the in-place form of the reference's donation)."""
        return getattr(self, f"_{name}").data_ptr()


def make_arena(lanes: int, width: int = WIDTH) -> ResidentArena:
    """The speculation plane's arena factory: one device, one arena (the
    reference's per-device mesh shards come with the multi-GPU port)."""
    return ResidentArena(lanes, width)
