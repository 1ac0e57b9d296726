"""Batched ZIP-215 ed25519 verification of lanes that each carry their
own key: the general kernel (K4) and its host side.

The host packs raw bytes (pubkeys, signatures, SHA-padded messages)
and checks S < L; the kernel does everything else per lane — SHA-512
of R||A||M, the fold of the challenge, ZIP-215 decompression of A and
R, and the cofactored check

    [8]([S]B - [k]A - R) == identity

with [k](-A) by 69 four-bit windows (4 doublings and one per-lane
table add each) and [S]B by the fixed-base comb ``b_comb_tables``.
Semantics match crypto/ed25519_ref.py and the reference's
tendermint_tpu/crypto/tpu/verify.py bit for bit.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from .. import ed25519_ref as ref
from ... import device as _device
from ...device import default_device
from ...libs import tracing
from . import edwards as ed
from .fieldsel import F as fe
from . import kernels
from . import ledger as _ledger
from . import scalar as sc
from . import sha512 as sh

# Warm the native packer at import (node and verifier start): its
# build-on-first-use cc subprocess must never run lazily inside a
# commit's verify.
try:
    from ...native import lib as _native_lib

    _native_lib()
except Exception:  # pragma: no cover - never block import on this
    pass
_L = ref.L
_MAX_BATCH = 1 << 15
_MIN_BATCH = 1 << 7
# Shard over the mesh only from this bucket size up: a tiny batch is not
# worth one launch per device (the reference's value).
_SHARD_MIN = 1 << 11
_DIGITS_K = sc.DIGITS_K  # windows in the scalar-multiplication loop

# L as four little-endian uint64 words, for the vectorized S < L check.
_L_WORDS = np.frombuffer(_L.to_bytes(32, "little"), np.uint64)


@functools.cache
def b_comb_tables() -> np.ndarray:
    """(69, 16, 3, NLIMB): affine (x, y, x*y) of j * 16^w * B in the
    selected field's canonical limbs, in its table dtype (int32 or
    float32). Entry (w, 0) is the identity (0, 1, 0); windows 64..68
    exist only to keep the 69-window loop uniform (S has 64 nibbles)
    and hold the identity throughout. Built once on the host with the
    pure-Python oracle."""
    tab = torch.zeros((_DIGITS_K, 16, 3, fe.NLIMB),
                      dtype=fe.TABLE_DTYPE).numpy()
    base = ref._B_PT
    for w in range(64):
        acc = ref.IDENTITY
        for j in range(16):
            if j == 0:
                x, y = 0, 1
            else:
                acc = ref.pt_add(acc, base)
                x, y = ref.from_extended(acc)
            tab[w, j, 0] = fe.to_limbs(x)
            tab[w, j, 1] = fe.to_limbs(y)
            tab[w, j, 2] = fe.to_limbs((x * y) % ref.P)
        for _ in range(4):
            base = ref.pt_double(base)
    tab[64:, :, 1, 0] = 1
    tab.setflags(write=False)
    return tab


def b_comb_from_reference(btab22: np.ndarray) -> np.ndarray:
    """The reference's (69, 16, 3, REF_NLIMB) comb table (built under the
    same TM_TPU_FIELD) in this port's limbs (the same converter as
    ExpandedKeys.from_reference_arrays)."""
    return fe.from_reference(btab22)


def pack_batch(pubs, msgs, sigs) -> dict[str, np.ndarray]:
    """Host-side preparation: raw byte arrays + SHA padding + S < L."""
    n = len(pubs)
    a_raw = np.frombuffer(b"".join(pubs), np.uint8).reshape(n, 32)
    sig_raw = np.frombuffer(b"".join(sigs), np.uint8).reshape(n, 64)
    return dict(pack_sig_msg(sig_raw, msgs), ab=a_raw)


def pack_sig_msg(sig_raw: np.ndarray, msgs) -> dict[str, np.ndarray]:
    """Signature/message half of the pack: signature rows, messages
    padded for a 64-byte R||A prefix (the width bucketed to a
    power-of-two block count), per-lane block counts and S < L."""
    msg_pad, nblocks = sh.pad_messages(list(msgs), prefix_len=64)
    total_blocks = (msg_pad.shape[1] + 64) // 128
    tb = 1
    while tb < total_blocks:
        tb <<= 1
    if tb != total_blocks:
        msg_pad = np.pad(msg_pad, ((0, 0), (0, (tb - total_blocks) * 128)))
    return dict(sb=sig_raw, msg=msg_pad, nblocks=nblocks,
                s_ok=s_range_ok(sig_raw))


def s_range_ok(sig_raw: np.ndarray) -> np.ndarray:
    """Per-lane S < L on (N, 64) signature rows (host-side; the kernel
    takes the verdict as an input mask)."""
    n = sig_raw.shape[0]
    s_words = sig_raw[:, 32:].copy().view(np.uint64)  # (n, 4) LE words
    lt = np.zeros(n, bool)
    gt = np.zeros(n, bool)
    for w in (3, 2, 1, 0):
        lt |= ~gt & ~lt & (s_words[:, w] < _L_WORDS[w])
        gt |= ~gt & ~lt & (s_words[:, w] > _L_WORDS[w])
    return lt


def to_device(packed: dict, device) -> dict:
    """numpy host arrays -> contiguous tensors on the device."""
    return {k: torch.from_numpy(np.require(v, requirements=["C", "W"])).to(device)
            for k, v in packed.items()}


def _btab(device) -> torch.Tensor:
    return _btab_cached(str(device))


@functools.cache
def _btab_cached(device: str) -> torch.Tensor:
    tab = torch.from_numpy(b_comb_tables().copy()).to(device)
    if tab.is_cuda:  # cached for every stream's use: let the copy land
        torch.cuda.synchronize(tab.device)
    return tab


def general_verify_plain(ab, sb, msg, nblocks, s_ok, btab) -> torch.Tensor:
    """Plain PyTorch version of K4 (csrc/general_verify.cu): the same
    steps on the selected field's limb tensors. ab (N, 32) u8, sb
    (N, 64) u8, msg (N, W) u8, nblocks (N,) i32, s_ok (N,) bool, btab
    (69, 16, 3, NLIMB) in the table dtype -> (N,) bool."""
    n = ab.shape[0]
    full = torch.cat([sb[:, :32], ab, msg], dim=1)
    digest = sh.compress_blocks(sh.bytes_to_words(full), nblocks)
    digk = sc.fold_digest(sh.digest_bytes_le(digest))  # MSB-first
    a_rows = ab.to(torch.int64).T
    s_rows = sb.to(torch.int64).T
    digs = sc.bytes_to_nibbles(s_rows[32:])
    digs = torch.cat([digs, torch.zeros((_DIGITS_K - 64, n), dtype=torch.int64,
                                        device=ab.device)])
    A, a_ok = ed.decompress_bytes(a_rows)
    R, r_ok = ed.decompress_bytes(s_rows[:32])
    tbl = ed.build_window_table(ed.neg(A), 16)
    neg_r = ed.neg(R)
    acc_a = acc_b = ed.identity(n, ab.device)
    for w in range(_DIGITS_K):
        for _ in range(4):
            acc_a = ed.double(acc_a)
        acc_a = ed.add(acc_a, ed.select(tbl, digk[w]))
        acc_b = ed.add_z1(acc_b, *ed.select_const(btab[w], digs[w]))
    v = ed.add(ed.add(acc_a, acc_b), neg_r)
    for _ in range(3):
        v = ed.double(v)
    return ed.is_identity(v) & a_ok & r_ok & s_ok


def general_verify(ab, sb, msg, nblocks, s_ok, btab) -> torch.Tensor:
    """K4 wrapper: the plain version for CPU tensors; the CUDA kernel
    for CUDA tensors (or KernelError)."""
    if ab.device.type == "cpu":
        return general_verify_plain(ab, sb, msg, nblocks, s_ok, btab)
    dev = ab.device
    n, width = msg.shape
    kernels.require(ab, "ab", torch.uint8, (n, 32), dev)
    kernels.require(sb, "sb", torch.uint8, (n, 64), dev)
    kernels.require(msg, "msg", torch.uint8, (n, width), dev)
    kernels.require(nblocks, "nblocks", torch.int32, (n,), dev)
    kernels.require(s_ok, "s_ok", torch.bool, (n,), dev)
    kernels.require(btab, "btab", fe.TABLE_DTYPE, (_DIGITS_K, 16, 3, fe.NLIMB),
                    dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    rc = kernels.lib().tm_general_verify(
        ab.data_ptr(), sb.data_ptr(), msg.data_ptr(), width,
        nblocks.data_ptr(), s_ok.data_ptr(), btab.data_ptr(), n,
        out.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(rc, "general_verify")
    general_verify.launches += 1
    return out


general_verify.launches = 0


# -- the mesh ------------------------------------------------------------


class Mesh(tuple):
    """A mesh: its torch devices in entry order, and ``names``, one per
    entry, unique within the base mesh — the device string when the
    device appears once, ``"<device>/<index in the base mesh>"`` when it
    repeats (``["cuda:0"] * 4`` is ``cuda:0/0`` .. ``cuda:0/3``). The
    per-entry breakers, evictions, the ``device.shard_fail`` payload and
    SHARD_LANES all go by these names, so evicting one logical shard of
    a card leaves its other shards serving. A degraded mesh keeps the
    names of the entries that survive."""

    names: tuple[str, ...]

    def __new__(cls, devices, names=None):
        self = super().__new__(cls, devices)
        self.names = tuple(names) if names is not None else entry_names(self)
        return self


def entry_names(devices) -> tuple[str, ...]:
    """Each entry's name in a base mesh (see Mesh)."""
    strs = [str(d) for d in devices]
    return tuple(s if strs.count(s) == 1 else f"{s}/{i}"
                 for i, s in enumerate(strs))


# base meshes by their device tuple, so that _mesh() returns one object
# for one mesh and `want is self.mesh` stays the placement fast path
_BASE_MESHES: dict[tuple, Mesh] = {}
# degraded meshes keyed by (base devices, evicted names); tiny (bounded
# by the distinct eviction sets a process sees)
_DEGRADED_MESHES: dict[tuple, Mesh] = {}


def _mesh() -> Mesh | None:
    """The base mesh the multi-device paths shard over (device.set_mesh,
    or every CUDA device when there are at least two), or None when
    fewer than two entries: the single-device path needs no mesh."""
    devs = _device.mesh_devices()
    if devs is None or len(devs) < 2:
        return None
    mesh = _BASE_MESHES.get(devs)
    if mesh is None:
        mesh = _BASE_MESHES.setdefault(devs, Mesh(devs))
    return mesh


def _shard_failpoints(mesh: Mesh) -> None:
    """The `device.shard_fail` point, evaluated once per entry per
    dispatch in mesh order (so `nth=K` selects the K-th entry of the
    first dispatch). The payload is the entry's name: `error` models a
    raising device, `corrupt` a wrong-verdict one (the payload comes
    back mangled); either evicts ONLY that entry."""
    from ...libs import failpoints

    if not failpoints.any_armed():
        return
    from .. import batch as cbatch

    for name in mesh.names:
        payload = name.encode()
        try:
            back = failpoints.hit("device.shard_fail", payload)
        except failpoints.FailpointError:
            cbatch.mark_device_failed("ed25519", device=name,
                                      reason="failpoint")
            continue
        if back is not None and bytes(back) != payload:
            cbatch.mark_device_failed("ed25519", device=name,
                                      reason="failpoint")


def effective_mesh(probe: bool = True) -> Mesh | None:
    """The mesh the next launch rides: the base mesh minus the entries
    the per-entry breakers evicted (crypto/batch.py). probe=True (a
    dispatch) also runs the due half-open probes, so a passing probe
    re-admits its entry and this very call returns the wider mesh.
    None when fewer than two entries survive."""
    base = _mesh()
    if base is None:
        return None
    _shard_failpoints(base)
    from .. import batch as cbatch

    evicted = tuple(cbatch.evicted_devices("ed25519", probe=probe))
    if not evicted:
        return base
    gone = set(evicted)
    keep = [i for i, name in enumerate(base.names) if name not in gone]
    if len(keep) < 2:
        return None
    key = (tuple(base), evicted)
    mesh = _DEGRADED_MESHES.get(key)
    if mesh is None:
        mesh = _DEGRADED_MESHES.setdefault(key, Mesh(
            [base[i] for i in keep], [base.names[i] for i in keep]))
    return mesh


def mesh_lane_pad(bucket: int, mesh) -> int:
    """Round a lane bucket up to the next multiple of the mesh size, so
    an odd bucket rides the mesh on padded lanes."""
    d = len(mesh)
    return -(-bucket // d) * d


# Lanes (padding included: a device runs them either way) launched per
# mesh entry, by entry name, over the process's lifetime.
SHARD_LANES: dict[str, int] = {}


def count_shard_lanes(mesh: Mesh, lanes: int) -> None:
    """Count `lanes` split evenly over the mesh into SHARD_LANES and
    tpu_shard_lanes_total{device=<entry name>}."""
    per = lanes // len(mesh)
    for name in mesh.names:
        SHARD_LANES[name] = SHARD_LANES.get(name, 0) + per
    try:
        from ...libs.metrics import tpu_metrics

        tmet = tpu_metrics()
        for name in mesh.names:
            tmet.shard_lanes.inc(per, device=name)
    except Exception:  # pragma: no cover - metrics never fatal
        pass


_STREAMS: dict[tuple[int, str], torch.cuda.Stream] = {}


def _shard_stream(i: int, dev: torch.device) -> torch.cuda.Stream:
    key = (i, str(dev))
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS.setdefault(key, torch.cuda.Stream(device=dev))
    return stream


def run_shards(mesh, launch) -> list:
    """Call launch(d, device) once for every mesh entry d: a CUDA entry
    on its device and its own stream, which first waits for the work
    already queued on the device (uploads, table builds), a CPU entry
    inline. Then each device's current stream waits on the shards'
    events, so whatever reads the results next sees them finished.
    Returns the launches' results in mesh order."""
    outs, joins = [], []
    for d, dev in enumerate(mesh):
        if dev.type != "cuda":
            outs.append(launch(d, dev))
            continue
        stream = _shard_stream(d, dev)
        with torch.cuda.device(dev):
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                outs.append(launch(d, dev))
            done = torch.cuda.Event()
            done.record(stream)
        joins.append((dev, done))
    for dev, done in joins:
        torch.cuda.current_stream(dev).wait_event(done)
    return outs


def sync_shards(outs) -> None:
    """kernels.sync on the stream of each shard of a run_shards call,
    before its results are read: a fault in a shard's kernel raises
    there, classified by its CUDA code."""
    for d, o in enumerate(outs):
        kernels.sync(o.device, _STREAMS.get((d, str(o.device))))


def gather(outs) -> torch.Tensor:
    """The shards' verdicts, concatenated in mesh order on the first
    entry's device (call after run_shards; syncs the shards first)."""
    sync_shards(outs)
    dev = outs[0].device
    return torch.cat([o.to(dev) for o in outs])


def launch_lanes(mesh, arrays: dict[str, np.ndarray], launch,
                 lane_axis: dict[str, int] | None = None,
                 grp: _ledger.LaunchGroup | None = None) -> torch.Tensor:
    """Lane-sharded launch: split the per-lane host arrays evenly over
    the mesh (their lane count is a multiple of its size), upload each
    share to its entry's device and run launch(d, tensors) there, then
    gather the verdicts in lane order. Arrays named in `lane_axis` keep
    their lanes on that axis (default 0). With a launch-ledger group,
    each entry's launch adds its record (lanes [d*per, (d+1)*per) of
    the call's verdicts)."""
    axis = lane_axis or {}
    lanes = next(v.shape[axis.get(k, 0)] for k, v in arrays.items())
    per = lanes // len(mesh)

    def one(d, dev):
        part = {k: np.take(v, np.arange(d * per, (d + 1) * per),
                           axis=axis.get(k, 0))
                for k, v in arrays.items()}
        tensors = to_device(part, dev)
        if grp is None:
            return launch(d, tensors)
        with grp.launch(dev, capacity=per, sel=slice(d * per, (d + 1) * per),
                        bytes_h2d=_ledger.nbytes_of(part),
                        **mesh_fields(mesh, d, [per] * len(mesh))):
            return launch(d, tensors)

    count_shard_lanes(mesh, lanes)
    return gather(run_shards(mesh, one))


def mesh_fields(mesh, d: int, shard_lanes: list[int]) -> dict:
    """The ledger fields of a launch on entry d of `mesh`: its name, the
    physical devices the mesh spans (four logical shards of one card are
    one device), the per-entry lane split and the entries."""
    return dict(shard=mesh.names[d], n_devices=len(set(mesh)),
                shard_lanes=shard_lanes, active_devices=list(mesh.names))


def sync_readback(grp, out: torch.Tensor, lanes: int) -> np.ndarray:
    """The verdicts of a dispatch site's launches on the host: wait for
    them (crypto.device_exec: the synchronisation before every readback,
    after which the ledger reads its exec events), then copy them
    (crypto.readback)."""
    t = tracing.TRACER
    with t.span(tracing.CRYPTO_DEVICE_EXEC, lanes=lanes):
        kernels.sync(out.device)
    with grp.stage("readback"), t.span(tracing.CRYPTO_READBACK, lanes=lanes):
        return out.cpu().numpy()


@functools.cache
def _dummy_triple() -> tuple[bytes, bytes, bytes]:
    """A fixed valid (pub, msg, sig) used to pad batches to bucket sizes."""
    seed = hashlib.sha256(b"tendermint_tpu batch pad").digest()
    pub = ref.public_key_from_seed(seed)
    msg = b"pad"
    return (pub, msg, ref.sign(seed, msg))


def lane_bucket(n: int) -> int:
    """A launch's lane bucket: powers of two from _MIN_BATCH up to 1024,
    then multiples of 1024 (a 10,240-lane commit runs at exactly
    10,240)."""
    if n <= 1024:
        bucket = _MIN_BATCH
        while bucket < n:
            bucket <<= 1
        return bucket
    return (n + 1023) // 1024 * 1024


def _chunks(n: int) -> list[int]:
    """One power-of-two bucket per launch whenever n fits in one; only
    batches beyond _MAX_BATCH split, into _MAX_BATCH pieces plus one
    padded tail."""
    out = []
    while n >= _MAX_BATCH:
        out.append(_MAX_BATCH)
        n -= _MAX_BATCH
    if n:
        up = _MIN_BATCH
        while up < n:
            up <<= 1
        out.append(up)
    return out


def verify_batch(pubs, msgs, sigs, device=None) -> np.ndarray:
    """Verify ed25519 (pub, msg, sig) triples on the device. Returns
    (N,) bool verdicts; ZIP-215 semantics identical to
    ed25519_ref.verify; malformed lengths fail cleanly. With no
    `device`, a bucket of _SHARD_MIN lanes or more splits over the mesh
    when there is one (padded to a multiple of its size with the dummy
    triple), one K4 launch per entry; otherwise, and always when a
    `device` is given, one launch on that device (default:
    device.default_device())."""
    n = len(pubs)
    assert len(msgs) == n and len(sigs) == n
    if n == 0:
        return np.zeros(0, bool)
    mesh = effective_mesh() if device is None else None
    device = default_device() if device is None else torch.device(device)
    well_formed = np.fromiter(
        (len(p) == 32 and len(s) == 64 for p, s in zip(pubs, sigs)),
        bool, count=n)
    if not well_formed.all():
        dp, dm, ds = _dummy_triple()
        pubs = [p if ok else dp for p, ok in zip(pubs, well_formed)]
        msgs = [m if ok else dm for m, ok in zip(msgs, well_formed)]
        sigs = [s if ok else ds for s, ok in zip(sigs, well_formed)]
    out = np.empty(n, bool)
    start = 0
    sizes = _chunks(n)
    _observe_batch(n, sizes)
    t = tracing.TRACER
    with t.span(tracing.CRYPTO_VERIFY, lanes=n, backend="general"):
        for size in sizes:
            end = min(start + size, n)
            shard = mesh is not None and size >= _SHARD_MIN
            if shard:
                size = mesh_lane_pad(size, mesh)
            with _ledger.group("general") as grp:
                with grp.stage("pack"), t.span(tracing.CRYPTO_PACK,
                                               lanes=size):
                    p, m, s = (list(pubs[start:end]), list(msgs[start:end]),
                               list(sigs[start:end]))
                    if size > end - start:
                        dp, dm, ds = _dummy_triple()
                        pad = size - (end - start)
                        p, m, s = p + [dp] * pad, m + [dm] * pad, s + [ds] * pad
                    packed = pack_batch(p, m, s)
                with t.span(tracing.CRYPTO_DISPATCH, lanes=size):
                    if shard:
                        res = launch_lanes(
                            mesh, packed, lambda d, tt: general_verify(
                                tt["ab"], tt["sb"], tt["msg"], tt["nblocks"],
                                tt["s_ok"], _btab(tt["ab"].device)), grp=grp)
                    else:
                        tt = to_device(packed, device)
                        with grp.launch(device, capacity=size,
                                        bytes_h2d=_ledger.nbytes_of(packed)):
                            res = general_verify(
                                tt["ab"], tt["sb"], tt["msg"], tt["nblocks"],
                                tt["s_ok"], _btab(device))
                host = sync_readback(grp, res, size)[: end - start]
                out[start:end] = host
                grp.settle(host)
            start = end
    return out & well_formed


def _observe_batch(n: int, sizes: list[int]) -> None:
    """tpu_batch_occupancy_ratio and tpu_batch_splits_total of one
    verify_batch call."""
    try:
        from ...libs.metrics import tpu_metrics

        tmet = tpu_metrics()
        tmet.batch_occupancy.observe(n / sum(sizes))
        if len(sizes) > 1:
            tmet.batch_splits.inc()
    except Exception:  # pragma: no cover - metrics never fatal
        pass
