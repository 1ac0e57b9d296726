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
- K8 ``mesh_splice``, ``mesh_clear`` and ``mesh_arena_verify``: the
  per-shard arena over a mesh (MeshResidentArena), reference
  ``_mesh_splice_fn``, ``_mesh_clear_fn`` and ``_mesh_arena_kernel``:
  K6's splice and clear and K7's verify launched once per device over
  its block of shards.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors (or raises KernelError).
"""

from __future__ import annotations

import contextlib
import logging
import time

import numpy as np
import torch

from ...device import default_device
from ...types.sign_batch import PATCH_W
from .. import batch as cbatch
from . import expanded as ex
from . import kernels
from . import verify as tv

logger = logging.getLogger("crypto.cuda.resident")

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
    bufs = (sb, s_ok, patch, split, patch_len, group, active)
    check_splice_buffers(*bufs)
    _splice_launch(bufs, packed, _delta_rows(packed))
    splice.launches += 1


splice.launches = 0

# Base alignment, in bytes, that K6's chunked copies need of each
# buffer they write (csrc/splice.cu), and of the packed rows.
_SPLICE_ALIGN = {"sb": 16, "patch": 8}
_PACKED_ALIGN = 16
# ... and K6's clear of the active mask (16 bytes a thread).
_ACTIVE_ALIGN = 16


def check_splice_buffers(sb, s_ok, patch, split, patch_len, group,
                         active) -> None:
    """The seven buffers a splice writes (K6's order): one device, their
    dtypes and shapes for one lane count, contiguous, and the base
    alignments K6 and the clear need (KernelError otherwise). A caller's
    buffers are checked at every splice() call; an arena's once, when
    it is built."""
    dev = sb.device
    n = sb.shape[0]
    kernels.require(sb, "sb", torch.uint8, (n, 64), dev)
    kernels.require(s_ok, "s_ok", torch.bool, (n,), dev)
    kernels.require(patch, "patch", torch.uint8, (n, PATCH_W), dev)
    for name, t in (("split", split), ("patch_len", patch_len),
                    ("group", group)):
        kernels.require(t, name, torch.int32, (n,), dev)
    kernels.require(active, "active", torch.bool, (n,), dev)
    for name, t in (("sb", sb), ("patch", patch)):
        kernels.require_aligned(t, name, _SPLICE_ALIGN[name])
    kernels.require_aligned(active, "active", _ACTIVE_ALIGN)


def _splice_launch(bufs, packed, k: int) -> None:
    """One tm_splice launch of k packed rows on CUDA tensors whose seven
    buffers `bufs` are checked (K6's and K8's splice; each counts its
    own launches)."""
    sb = bufs[0]
    dev = sb.device
    kernels.require(packed, "packed", torch.uint8, (k * ROW_BYTES,), dev)
    kernels.require_aligned(packed, "packed", _PACKED_ALIGN)
    rc = kernels.lib().tm_splice(
        packed.data_ptr(), k, sb.shape[0], *(t.data_ptr() for t in bufs),
        kernels.stream_ptr(dev))
    kernels.check(rc, "splice")


class _Splicer:
    """The splice of one device's arena buffers (K6's, or K8's for a
    mesh block): the seven buffers checked once, here, and on a CUDA
    device a pinned host staging buffer, with its device twin, grown to
    the largest burst and reused. A splice copies its packed rows into
    the staging buffer, uploads them with one asynchronous copy on the
    launch stream and launches K6 after it on the same stream; before
    the host overwrites the staging buffer it waits on the event
    recorded after the previous copy. On the CPU the packed rows go to
    the wrapper (splice or mesh_splice), which runs the plain
    version."""

    def __init__(self, bufs: tuple, mesh: bool):
        check_splice_buffers(*bufs)
        self.bufs = bufs
        self.mesh = mesh
        self.device = bufs[0].device
        self._host = self._dev = self._copied = None

    def __call__(self, packed: np.ndarray) -> None:
        if self.device.type != "cuda":
            fn = mesh_splice if self.mesh else splice
            fn(*self.bufs, torch.from_numpy(packed))
            return
        with torch.cuda.device(self.device):
            _splice_launch(self.bufs, self._upload(packed),
                           packed.nbytes // ROW_BYTES)
        if self.mesh:
            mesh_splice.launches += 1
        else:
            splice.launches += 1

    def _upload(self, packed: np.ndarray) -> torch.Tensor:
        nbytes = packed.nbytes
        if self._copied is not None:
            self._copied.synchronize()  # the last copy has read the buffer
        if self._host is None or self._host.numel() < nbytes:
            self._host = torch.empty(nbytes, dtype=torch.uint8,
                                     pin_memory=True)
            self._dev = torch.empty(nbytes, dtype=torch.uint8,
                                    device=self.device)
            self._copied = torch.cuda.Event()
        self._host.numpy()[:nbytes] = packed
        rows = self._dev[:nbytes]
        rows.copy_(self._host[:nbytes], non_blocking=True)
        self._copied.record()
        return rows


def clear_plain(active) -> None:
    """Plain PyTorch version of K6's clear: every lane inactive but the
    sentinel lane 0, in place."""
    active.zero_()
    active[0] = True


def clear(active) -> None:
    """K6 clear wrapper: plain version for CPU tensors, one launch of
    the CUDA kernel for CUDA tensors (or KernelError)."""
    if active.device.type == "cpu":
        clear_plain(active)
        return
    n = active.shape[0]
    _clear_launch(active, n, n)
    clear.launches += 1


clear.launches = 0


def _clear_launch(active, per: int, n: int) -> None:
    """One tm_clear launch (K6's clear with per = n, K8's with per = a
    shard's lanes; each wrapper counts its own launches): lane i stays
    active iff i % per == 0."""
    dev = active.device
    kernels.require(active, "active", torch.bool, (n,), dev)
    kernels.require_aligned(active, "active", _ACTIVE_ALIGN)
    rc = kernels.lib().tm_clear(active.data_ptr(), per, n,
                                kernels.stream_ptr(dev))
    kernels.check(rc, "clear")


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
    out = _arena_verify_launch(ab, sb, s_ok, active, pre, pre_len, suf,
                               suf_len, patch, split, patch_len, group, btab,
                               width)
    arena_verify.launches += 1
    return out


arena_verify.launches = 0


def _arena_verify_launch(ab, sb, s_ok, active, pre, pre_len, suf, suf_len,
                         patch, split, patch_len, group, btab,
                         width) -> torch.Tensor:
    """One tm_arena_verify launch on CUDA tensors (K7's and K8's verify;
    each wrapper counts its own launches)."""
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
    kernels.require(btab, "btab", tv.fe.TABLE_DTYPE,
                    tuple(tv.b_comb_tables().shape), dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    rc = kernels.lib().tm_arena_verify(
        ab.data_ptr(), sb.data_ptr(), s_ok.data_ptr(), active.data_ptr(),
        pre.data_ptr(), pre_len.data_ptr(), suf.data_ptr(),
        suf_len.data_ptr(), patch.data_ptr(), split.data_ptr(),
        patch_len.data_ptr(), group.data_ptr(), btab.data_ptr(), n, width,
        out.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(rc, "arena_verify")
    return out


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
        self._splice = _Splicer(self.buffers(), mesh=False)
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
        upload of their packed rows (105 B each, from the pinned staging
        buffer) and one K6 launch."""
        if len(slots) == 0:
            return
        packed = self.pack(slots, sig_rows, patch, split, patch_len, group)
        self.reupload_bytes += packed.nbytes
        self._live[np.asarray(slots, np.int64)] = True
        self._splice(packed)

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
        return kernels.readback(arena_verify(*self.launch_args(),
                                             width=self.width))

    def buffer_pointer(self, name: str = "sb") -> int:
        """data_ptr() of a resident buffer: a splice leaves it as it
        was (the in-place form of the reference's donation)."""
        return getattr(self, f"_{name}").data_ptr()


# -- K8: the per-shard arena over a mesh ---------------------------------
#
# The reference's three mesh programs are K6 and K7 vmapped over a
# leading device axis, (D, per, ...) arrays sharded one shard a device.
# Here a device's shards are ONE contiguous block of its buffers — shard
# e of the device at lanes [e*per, (e+1)*per), its sentinel at e*per —
# so a splice is one packed upload and one K6 launch per device, a
# launch one K7 launch per device over its whole block, and a clear one
# launch of K6's clear per device (a lane active iff it is its shard's
# first). The plain versions below are the
# reference's programs over the (D, per, ...) view; the tests and
# chip_smoke.py hold the blocks against them.


def mesh_splice_plain(bufs, packed) -> None:
    """Plain version of K8's splice (_mesh_splice_fn): `bufs` are the
    seven (D, per, ...) buffers in K6's order, `packed` D packed deltas
    (pack_delta rows with local slots); shard d's rows go into row d of
    every buffer, in place."""
    for d, p in enumerate(packed):
        if p.numel():
            splice_plain(*(b[d] for b in bufs), p)


def mesh_clear_plain(active) -> None:
    """Plain version of K8's clear (_mesh_clear_fn) on the (D, per)
    active view: every lane inactive but each shard's sentinel."""
    active.zero_()
    active[:, 0] = True


def mesh_arena_verify_plain(ab, sb, s_ok, active, pre, pre_len, suf,
                            suf_len, patch, split, patch_len, group, btab,
                            width: int = WIDTH) -> torch.Tensor:
    """Plain version of K8's verify (_mesh_arena_kernel): K7's plain
    version on each shard of the (D, per, ...) buffers -> (D, per)
    bool."""
    return torch.stack([
        arena_verify_plain(ab[d], sb[d], s_ok[d], active[d], pre, pre_len,
                           suf, suf_len, patch[d], split[d], patch_len[d],
                           group[d], btab, width)
        for d in range(ab.shape[0])])


def mesh_splice(sb, s_ok, patch, split, patch_len, group, active,
                packed) -> None:
    """K8's splice on one device: its packed delta rows (block lane
    positions) into its shard block in place — one launch of K6's
    kernel, counted here and not under K6 (the plain version for CPU
    tensors)."""
    if sb.device.type == "cpu":
        splice_plain(sb, s_ok, patch, split, patch_len, group, active,
                     packed)
        return
    bufs = (sb, s_ok, patch, split, patch_len, group, active)
    check_splice_buffers(*bufs)
    _splice_launch(bufs, packed, _delta_rows(packed))
    mesh_splice.launches += 1


mesh_splice.launches = 0


def mesh_clear(active, per: int) -> None:
    """K8's clear on one device's block of shards of `per` lanes: the
    plain version for a CPU tensor, one launch of K6's clear kernel
    (lane i active iff i % per == 0), counted here, for a CUDA tensor
    (or KernelError)."""
    n = active.shape[0]
    if per <= 0 or n % per:
        raise kernels.KernelError(f"mesh_clear: {n} lanes in shards of {per}")
    if active.device.type == "cpu":
        mesh_clear_plain(active.view(-1, per))
        return
    _clear_launch(active, per, n)
    mesh_clear.launches += 1


mesh_clear.launches = 0


def mesh_arena_verify(*args, width: int = WIDTH) -> torch.Tensor:
    """K8's verify on one device: one launch of K7's kernel over its
    whole shard block, counted here and not under K7 (the plain version
    for CPU tensors), arguments as arena_verify's."""
    if args[0].device.type == "cpu":
        return arena_verify_plain(*args, width=width)
    out = _arena_verify_launch(*args, width=width)
    mesh_arena_verify.launches += 1
    return out


mesh_arena_verify.launches = 0


def _on(dev):
    """Launch context of a device: raw-stream launches must run with it
    current."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


_BUF_NAMES = ("ab", "sb", "s_ok", "patch", "split", "patch_len", "group",
              "active")
_SPLICED = _BUF_NAMES[1:]  # K6's argument order


class MeshResidentArena:
    """Arena shards over the mesh (reference: MeshResidentArena), one
    shard a mesh entry, each with its own known-answer sentinel.

    Global app slots (1..capacity-1, the SpeculationPlane's
    validator_index + 1) round-robin over the shards: slot s lives on
    shard (s-1) % D at local slot (s-1) // D + 1, so a commit's
    precommits spread evenly and each shard's splice carries ~1/D of
    the delta rows. A device holds its shards as one contiguous block
    (see above). ``launch`` returns verdicts in global slot order;
    ``sentinel_ok`` holds each shard's known-answer result, so a
    wrong-verdict entry is named (``failed_shards``) instead of the
    whole mesh; slot 0 of the verdicts is the AND of every sentinel."""

    def __init__(self, lanes: int, width: int = WIDTH, mesh=None):
        if width > WIDTH or (64 + width) % 128:
            raise ValueError(f"arena width {width}")
        mesh = tv.effective_mesh() if mesh is None else mesh
        assert mesh is not None, "MeshResidentArena needs a device mesh"
        self.mesh = mesh
        self.names = list(mesh.names)
        self.width = width
        self._req_lanes = lanes
        # global slot -> key bytes: ensure_mesh replays them into the
        # new layout when the shard set changes
        self._keys_host: dict[int, bytes] = {}
        d_n = self.n_shards = len(mesh)
        per = ex.ExpandedKeys._bucket(
            max(-(-(max(lanes, 2) - 1) // d_n) + 1, 2))
        self.shard_capacity = per
        self.capacity = 1 + d_n * (per - 1)
        self.sentinel_ok: list[bool] | None = None
        spub, smsg, ssig = cbatch._ed_probe_triple()
        assert len(smsg) <= PRE_W
        by_dev: dict[str, list[int]] = {}
        for d, dev in enumerate(mesh):
            by_dev.setdefault(str(dev), []).append(d)
        # entry -> its block and the lane offset of its shard there
        self._block_of = np.zeros(d_n, np.int64)
        self._off_of = np.zeros(d_n, np.int64)
        self._blocks = []
        for b, shards in enumerate(by_dev.values()):
            n = len(shards) * per
            ab = np.zeros((n, 32), np.uint8)
            sb = np.zeros((n, 64), np.uint8)
            ab[::per] = np.frombuffer(spub, np.uint8)
            sb[::per] = np.frombuffer(ssig, np.uint8)
            active = np.zeros(n, bool)
            active[::per] = True
            host = dict(ab=ab, sb=sb, s_ok=tv.s_range_ok(sb),
                        patch=np.zeros((n, PATCH_W), np.uint8),
                        split=np.zeros(n, np.int32),
                        patch_len=np.zeros(n, np.int32),
                        group=np.zeros(n, np.int32), active=active)
            dev = mesh[shards[0]]
            with _on(dev):
                bufs = {k: torch.from_numpy(v).to(dev)
                        for k, v in host.items()}
            self._blocks.append(dict(
                device=dev, shards=shards, bufs=bufs, ab_host=ab,
                templates=None,
                splice=_Splicer(tuple(bufs[k] for k in _SPLICED), mesh=True)))
            for e, d in enumerate(shards):
                self._block_of[d] = b
                self._off_of[d] = e * per
        self.pre = np.zeros((GROUPS, PRE_W), np.uint8)
        self.pre_len = np.zeros(GROUPS, np.int32)
        self.suf = np.zeros((GROUPS, SUF_W), np.uint8)
        self.suf_len = np.zeros(GROUPS, np.int32)
        self.pre[0, :len(smsg)] = np.frombuffer(smsg, np.uint8)
        self.pre_len[0] = len(smsg)
        # host mirror of `active`, (D, per) (the kernels never read it
        # back)
        self._live = np.zeros((d_n, per), bool)
        self._live[:, 0] = True
        self.reupload_bytes = 0
        self._shard_reupload = np.zeros(d_n, np.int64)
        self.last_reshard_s: float | None = None

    # -- sizes and views ------------------------------------------------

    def arena_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for blk in self._blocks for t in blk["bufs"].values())

    @property
    def active_lanes(self) -> int:
        """Active lanes, every shard's sentinel included."""
        return int(self._live.sum())

    def shard_reupload_bytes(self) -> list[int]:
        """Bytes uploaded for each shard: its own delta rows, and the
        templates each time its device received them — the accounting
        the reference's bound reads (single-arena bytes / D + the
        template bytes)."""
        return [int(x) for x in self._shard_reupload]

    def view(self, name: str, device="cpu") -> torch.Tensor:
        """The (D, per, ...) view of a resident buffer, in the
        reference's layout, gathered on `device`."""
        per = self.shard_capacity
        return torch.stack([
            self._blocks[self._block_of[d]]["bufs"][name][
                self._off_of[d]:self._off_of[d] + per].to(device)
            for d in range(self.n_shards)])

    def buffer_pointer(self, name: str = "sb", shard: int = 0) -> int:
        """data_ptr() of one shard's slice of a resident buffer: a splice
        leaves it as it was."""
        buf = self._blocks[self._block_of[shard]]["bufs"][name]
        return buf[self._off_of[shard]:].data_ptr()

    # -- slow-path installs (valset / height changes) -------------------

    def install_keys(self, pubkeys: list[bytes], start: int = 1) -> None:
        """Upload pubkey rows for global slots start.. — once per
        validator-set change, each to its home shard."""
        assert start >= 1, "slot 0 is the sentinel"
        assert start + len(pubkeys) <= self.capacity
        assert all(len(p) == 32 for p in pubkeys)
        for off, p in enumerate(pubkeys):
            self._keys_host[start + off] = bytes(p)
        i = np.arange(start - 1, start - 1 + len(pubkeys))
        home = i % self.n_shards
        pos = self._off_of[home] + i // self.n_shards + 1
        rows = np.frombuffer(b"".join(pubkeys), np.uint8).reshape(-1, 32)
        for b, blk in enumerate(self._blocks):
            sel = self._block_of[home] == b
            if sel.any():
                blk["ab_host"][pos[sel]] = rows[sel]
                with _on(blk["device"]):
                    blk["bufs"]["ab"].copy_(torch.from_numpy(blk["ab_host"]))

    def set_template(self, group: int, pre: bytes, suf: bytes) -> None:
        """Stage a (pre, suf) template row (group 0 is the sentinels');
        every device gets the templates at its next launch."""
        assert 1 <= group < GROUPS
        assert len(pre) <= PRE_W and len(suf) <= SUF_W
        self.pre[group] = 0
        self.suf[group] = 0
        self.pre[group, :len(pre)] = np.frombuffer(pre, np.uint8)
        self.suf[group, :len(suf)] = np.frombuffer(suf, np.uint8)
        self.pre_len[group] = len(pre)
        self.suf_len[group] = len(suf)
        for blk in self._blocks:
            blk["templates"] = None

    def deactivate_all(self) -> None:
        """New height: every lane but the shards' sentinels goes
        inactive (one K8 clear a device)."""
        for blk in self._blocks:
            with _on(blk["device"]):
                mesh_clear(blk["bufs"]["active"], self.shard_capacity)
        self._live[:, 1:] = False

    def ensure_mesh(self) -> bool:
        """Rebuild the arena over the current effective mesh when its
        entries changed (an eviction, or a re-admission): the installed
        keys replay into the new round-robin layout and the templates
        and reupload_bytes are kept; the splice state is not — lanes
        come back inactive, the deactivate_all contract, and the
        caller's next splice repopulates them. Returns whether it
        rebuilt."""
        want = tv.effective_mesh()
        if want is None or want is self.mesh:
            return False
        if want.names == self.mesh.names:
            self.mesh = want  # the same entries, another object
            return False
        t0 = time.perf_counter()
        templates = self.pre, self.pre_len, self.suf, self.suf_len
        keys = dict(self._keys_host)
        reup = self.reupload_bytes
        self.__init__(self._req_lanes, self.width, mesh=want)
        self.pre, self.pre_len, self.suf, self.suf_len = templates
        self.reupload_bytes = reup
        # replay in contiguous runs; slots past the new capacity are
        # dropped, as by a fresh arena of the requested lanes
        slots = sorted(s for s in keys if s < self.capacity)
        run: list[bytes] = []
        for j, s in enumerate(slots):
            run.append(keys[s])
            if j + 1 == len(slots) or slots[j + 1] != s + 1:
                self.install_keys(run, start=s + 1 - len(run))
                run = []
        self.last_reshard_s = time.perf_counter() - t0
        logger.warning("live arena reshard: %d-lane arena rebuilt over %d "
                       "shards in %.3fs", self._req_lanes, self.n_shards,
                       self.last_reshard_s)
        return True

    # -- the steady-state hot path --------------------------------------

    def splice(self, slots, sig_rows: np.ndarray, patch: np.ndarray,
               split: np.ndarray, patch_len: np.ndarray,
               group: np.ndarray) -> None:
        """Route each arriving lane to its home shard and splice it: per
        device ONE upload of its rows (105 B each, block positions, from
        the device's pinned staging buffer) and one K6 launch; a device
        with no rows launches nothing. A slot
        given twice keeps its last row, as the reference's scatter
        does."""
        k = len(slots)
        if k == 0:
            return
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
        s_ok = tv.s_range_ok(sig_rows)
        d_n = self.n_shards
        home = (pos - 1) % d_n
        local = (pos - 1) // d_n + 1
        self._live[home, local] = True
        np.add.at(self._shard_reupload, home, ROW_BYTES)
        for b, blk in enumerate(self._blocks):
            sel = np.flatnonzero(self._block_of[home] == b)
            if not sel.size:
                continue
            packed = pack_delta(self._off_of[home[sel]] + local[sel],
                                sig_rows[sel], s_ok[sel], patch[sel],
                                split[sel], patch_len[sel], group[sel])
            self.reupload_bytes += packed.nbytes
            blk["splice"](packed)

    def launch_args(self, b: int) -> tuple:
        """K7's arguments over block b's buffers (the templates uploaded
        to its device first if they changed)."""
        blk = self._blocks[b]
        if blk["templates"] is None:
            host = (self.pre, self.pre_len, self.suf, self.suf_len)
            with _on(blk["device"]):
                blk["templates"] = tuple(
                    torch.from_numpy(a.copy()).to(blk["device"])
                    for a in host)
            nbytes = sum(a.nbytes for a in host)
            self.reupload_bytes += nbytes
            for d in blk["shards"]:
                self._shard_reupload[d] += nbytes
        bufs = blk["bufs"]
        pre, pre_len, suf, suf_len = blk["templates"]
        return (bufs["ab"], bufs["sb"], bufs["s_ok"], bufs["active"], pre,
                pre_len, suf, suf_len, bufs["patch"], bufs["split"],
                bufs["patch_len"], bufs["group"], tv._btab(blk["device"]))

    def launch(self) -> np.ndarray:
        """Verify every active lane of every shard: one K8 verify (K7
        over the device's block) per device, each on its device and
        stream, joined. Returns (capacity,) verdicts in global slot
        order; slot 0 is the AND of the shards' sentinels, which
        ``sentinel_ok`` holds one by one."""
        args = [self.launch_args(b) for b in range(len(self._blocks))]
        outs = tv.run_shards(
            [blk["device"] for blk in self._blocks],
            lambda b, _dev: mesh_arena_verify(*args[b], width=self.width))
        d_n, per = self.n_shards, self.shard_capacity
        tv.sync_shards(outs)
        blocks = [o.cpu().numpy().reshape(-1, per) for o in outs]
        o = np.stack([blocks[self._block_of[d]][self._off_of[d] // per]
                      for d in range(d_n)])
        self.sentinel_ok = [bool(o[d, 0]) for d in range(d_n)]
        verd = np.zeros(self.capacity, bool)
        verd[0] = all(self.sentinel_ok)
        for d in range(d_n):
            verd[1 + d::d_n] = o[d, 1:]
        return verd

    def failed_shards(self) -> list[tuple[int, str]]:
        """(shard index, entry name) of every sentinel that failed on
        the last launch: the per-entry breaker attribution."""
        if self.sentinel_ok is None:
            return []
        return [(i, self.names[i])
                for i, ok in enumerate(self.sentinel_ok) if not ok]

    @classmethod
    def from_reference_arrays(cls, arrays: dict, templates=None, keys=None,
                              width: int = WIDTH, mesh=None):
        """Carry a reference arena's state over: ``arrays`` holds its
        (D, per, ...) numpy buffers by name (ab, sb, s_ok, patch,
        split, patch_len, group, active), ``templates`` its (pre,
        pre_len, suf, suf_len) and ``keys`` its installed keys (global
        slot -> bytes; else read from the non-zero key rows). The
        port's mesh (default: the effective one) must have D entries."""
        d_n, per = np.asarray(arrays["active"]).shape
        mesh = tv.effective_mesh() if mesh is None else mesh
        if mesh is None or len(mesh) != d_n:
            raise ValueError(f"a {d_n}-shard reference arena needs a mesh "
                             f"of {d_n} entries")
        self = cls(1 + d_n * (per - 1), width, mesh=mesh)
        if self.shard_capacity != per:
            raise ValueError(f"shard capacity {per} is not a lane bucket")
        for name in _BUF_NAMES:
            a = np.asarray(arrays[name])
            for d in range(d_n):
                blk = self._blocks[self._block_of[d]]
                off = self._off_of[d]
                with _on(blk["device"]):
                    blk["bufs"][name][off:off + per].copy_(
                        torch.from_numpy(np.ascontiguousarray(a[d])))
                if name == "ab":
                    blk["ab_host"][off:off + per] = a[d]
        self._live = np.asarray(arrays["active"], bool).copy()
        if templates is not None:
            self.pre, self.pre_len, self.suf, self.suf_len = (
                np.asarray(t).copy() for t in templates)
        if keys is None:
            ab = np.asarray(arrays["ab"])
            keys = {1 + (j - 1) * d_n + d: bytes(ab[d, j])
                    for d in range(d_n) for j in range(1, per)
                    if ab[d, j].any()}
        self._keys_host = {int(s): bytes(k) for s, k in keys.items()}
        return self


def make_arena(lanes: int, width: int = WIDTH):
    """The speculation plane's arena factory: arena shards over the
    effective mesh when there is one, else one ResidentArena on the
    default device."""
    mesh = tv.effective_mesh()
    if mesh is not None:
        return MeshResidentArena(lanes, width, mesh=mesh)
    return ResidentArena(lanes, width)
