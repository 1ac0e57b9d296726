"""Batched sr25519 (schnorrkel) verification: Merlin on the host
(numpy, crypto/merlin_batch.py), the group equation on the GPU (K9,
csrc/sr_verify.cu).

Per lane, schnorrkel verify accepts iff

    encode([s]B - [k]A) == R_bytes

with k the Merlin transcript challenge (host) and encode the ristretto
encoding. Over the quotient group that is ristretto EQUALITY of
V = [s]B + [k](-A) and decode(R_bytes), so the kernel never encodes:
it decodes A and R (crypto/cuda/ristretto.py), runs one 64-window loop
— [k](-A) by per-lane 4-bit windows, [s]B by the fixed-base comb (the
first 64 windows of ``verify.b_comb_tables``; k and s are below
L < 2^253, 64 nibbles each) — and compares. Semantics match
``sr25519_ref.verify`` and the reference's
tendermint_tpu/crypto/tpu/sr_verify.py bit for bit: the marker bit is
required, s must be canonical (< L), A and R must be canonical
ristretto encodings.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import ed25519_ref as ref
from ..merlin_batch import sr25519_challenges
from ...device import default_device
from . import edwards as ed
from .fieldsel import F as fe
from . import kernels
from . import ristretto as rs
from . import verify as tv

WINDOWS = 64  # k, s < L < 2^253: 64 nibbles each

_P_WORDS = np.frombuffer(ref.P.to_bytes(32, "little"), np.uint64)
_L_WORDS = np.frombuffer(ref.L.to_bytes(32, "little"), np.uint64)


def _lt_words(vals: np.ndarray, bound_words: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 little-endian < bound, vectorized per 64-bit word."""
    words = vals.copy().view(np.uint64)  # (N, 4)
    lt = np.zeros(len(vals), bool)
    gt = np.zeros(len(vals), bool)
    for w in (3, 2, 1, 0):
        lt |= ~gt & ~lt & (words[:, w] < bound_words[w])
        gt |= ~gt & ~lt & (words[:, w] > bound_words[w])
    return lt


def _nibbles_of_bytes(raw: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 little-endian scalars -> (64, N) uint8 nibbles,
    LSB first."""
    out = np.empty((64, raw.shape[0]), np.uint8)
    out[0::2] = (raw & 0x0F).T
    out[1::2] = (raw >> 4).T
    return out


def _nibbles(ints, n: int) -> np.ndarray:
    """(N,) python ints < 2^256 -> (64, N) uint8 nibbles LSB-first."""
    raw = np.frombuffer(
        b"".join(int(v).to_bytes(32, "little") for v in ints), np.uint8
    ).reshape(n, 32)
    return _nibbles_of_bytes(raw)


def check_bytes(pubs, sigs) -> dict[str, np.ndarray]:
    """The host's byte checks: well_formed (a 32-byte key, a 64-byte
    signature with the marker bit), safe substitutes for the other
    lanes, A and R rows, s with the marker stripped, s_ok (s < L), and
    a_pre / r_pre (the encoding < p and even)."""
    n = len(pubs)
    well_formed = np.fromiter(
        ((len(p) == 32 and len(s) == 64 and (s[63] & 0x80) != 0)
         for p, s in zip(pubs, sigs)), bool, count=n)
    safe_sigs = [s if ok else b"\0" * 63 + b"\x80"
                 for s, ok in zip(sigs, well_formed)]
    safe_pubs = [p if ok else b"\0" * 32 for p, ok in zip(pubs, well_formed)]
    a_raw = np.frombuffer(b"".join(safe_pubs), np.uint8).reshape(n, 32)
    sig_raw = np.frombuffer(b"".join(safe_sigs), np.uint8).reshape(n, 64)
    r_raw = np.ascontiguousarray(sig_raw[:, :32])
    s_raw = np.ascontiguousarray(sig_raw[:, 32:])
    s_raw[:, 31] &= 0x7F  # strip the schnorrkel marker bit
    return dict(
        well_formed=well_formed, ab=a_raw, rb=r_raw, s_raw=s_raw,
        s_ok=_lt_words(s_raw, _L_WORDS),
        a_pre=_lt_words(a_raw, _P_WORDS) & ((a_raw[:, 0] & 1) == 0),
        r_pre=_lt_words(r_raw, _P_WORDS) & ((r_raw[:, 0] & 1) == 0))


def pack_batch_sr(pubs, msgs, sigs, ctx: bytes = b""):
    """Host-side preparation: the byte checks, then the Merlin
    challenges (the transcript sees the wire bytes of A and R; R is
    sig[:32] as is) and both scalars' nibbles. Returns the kernel's
    inputs as numpy arrays and the well-formed mask."""
    c = check_bytes(pubs, sigs)
    ks = sr25519_challenges(c["ab"], list(msgs), c["rb"], ctx)
    packed = dict(ab=c["ab"], rb=c["rb"], kdig=_nibbles(ks, len(pubs)),
                  sdig=_nibbles_of_bytes(c["s_raw"]), a_pre=c["a_pre"],
                  r_pre=c["r_pre"], s_ok=c["s_ok"])
    return packed, c["well_formed"]


def comb_table(device) -> torch.Tensor:
    """The comb's first 64 windows on the device, (64, 16, 3, NLIMB) in
    the table dtype (a contiguous view of verify's cached table)."""
    return tv._btab(device)[:WINDOWS]


def encoding_limbs(ab, rb) -> torch.Tensor:
    """(N, 32) u8 encodings of A and R -> (NLIMB, 2N) limbs of their low
    255 bits, A's lanes first (the kernel's fe_frombytes; bit 255 is
    left to the byte checks)."""
    rows = torch.cat([ab, rb]).to(torch.int64).T  # (32, 2N)
    return fe.limbs_from_bytes(torch.cat([rows[:31], (rows[31] & 0x7F)[None]]))


def sr_points_plain(ab, rb, kdig, sdig, a_pre, r_pre, btab):
    """K9's arithmetic up to the comparison: (V, decoded R, a_ok, r_ok)
    with V = [s]B + [k](-A)."""
    n = ab.shape[0]
    p2, ok2 = rs.decode(encoding_limbs(ab, rb), torch.cat([a_pre, r_pre]))
    a = ed.Point(*(c[:, :n] for c in p2))
    r = ed.Point(*(c[:, n:] for c in p2))
    tbl = ed.build_window_table(ed.neg(a), 16)
    kd, sd = kdig.to(torch.int64), sdig.to(torch.int64)
    acc_a = acc_b = ed.identity(n, ab.device)
    for w in range(WINDOWS):
        for _ in range(4):
            acc_a = ed.double(acc_a)
        acc_a = ed.add(acc_a, ed.select(tbl, kd[WINDOWS - 1 - w]))
        acc_b = ed.add_z1(acc_b, *ed.select_const(btab[w], sd[w]))
    return ed.add(acc_a, acc_b), r, ok2[:n], ok2[n:]


def sr_verify_plain(ab, rb, kdig, sdig, a_pre, r_pre, s_ok, btab):
    """Plain PyTorch version of K9 (csrc/sr_verify.cu). ab, rb (N, 32)
    u8; kdig, sdig (64, N) u8 nibbles LSB first; a_pre, r_pre, s_ok
    (N,) bool; btab (64, 16, 3, NLIMB) in the table dtype -> (N,)
    bool."""
    v, r, a_ok, r_ok = sr_points_plain(ab, rb, kdig, sdig, a_pre, r_pre,
                                       btab)
    return rs.equal(v, r) & a_ok & r_ok & s_ok


def sr_verify(ab, rb, kdig, sdig, a_pre, r_pre, s_ok, btab):
    """K9 wrapper: the plain version for CPU tensors; the CUDA kernel
    for CUDA tensors (or KernelError)."""
    if ab.device.type == "cpu":
        return sr_verify_plain(ab, rb, kdig, sdig, a_pre, r_pre, s_ok, btab)
    dev = ab.device
    n = ab.shape[0]
    kernels.require(ab, "ab", torch.uint8, (n, 32), dev)
    kernels.require(rb, "rb", torch.uint8, (n, 32), dev)
    kernels.require(kdig, "kdig", torch.uint8, (WINDOWS, n), dev)
    kernels.require(sdig, "sdig", torch.uint8, (WINDOWS, n), dev)
    for name, t in (("a_pre", a_pre), ("r_pre", r_pre), ("s_ok", s_ok)):
        kernels.require(t, name, torch.bool, (n,), dev)
    kernels.require(btab, "btab", fe.TABLE_DTYPE,
                    (WINDOWS, 16, 3, fe.NLIMB), dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    rc = kernels.lib().tm_sr_verify(
        ab.data_ptr(), rb.data_ptr(), kdig.data_ptr(), sdig.data_ptr(),
        a_pre.data_ptr(), r_pre.data_ptr(), s_ok.data_ptr(), btab.data_ptr(),
        n, out.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(rc, "sr_verify")
    sr_verify.launches += 1
    return out


sr_verify.launches = 0


def verify_batch_sr(pubs, msgs, sigs, ctx: bytes = b"",
                    device=None) -> np.ndarray:
    """Verify sr25519 (pub, msg, sig) triples with the group equation on
    the device. Returns (N,) bool verdicts with sr25519_ref.verify's
    semantics; malformed lengths and unmarked signatures fail cleanly.
    With no `device`, a lane bucket of verify._SHARD_MIN or more splits
    over the mesh when there is one (padded with inert zero lanes to a
    multiple of its size), one K9 launch per entry; otherwise, and
    always when a `device` is given ("cpu" runs the plain version, the
    counterpart of the reference's cpu=True, which bypasses the mesh),
    one launch on that device (default: device.default_device())."""
    n = len(pubs)
    assert len(msgs) == n and len(sigs) == n
    if n == 0:
        return np.zeros(0, bool)
    mesh = tv.effective_mesh() if device is None else None
    device = default_device() if device is None else torch.device(device)
    packed, well_formed = pack_batch_sr(pubs, msgs, sigs, ctx)
    bucket = tv.lane_bucket(n)
    if mesh is None or bucket < tv._SHARD_MIN:
        t = tv.to_device(packed, device)
        out = sr_verify(t["ab"], t["rb"], t["kdig"], t["sdig"], t["a_pre"],
                        t["r_pre"], t["s_ok"], comb_table(device))
        return kernels.readback(out) & well_formed
    pad = tv.mesh_lane_pad(bucket, mesh) - n
    nibbles = {"kdig": 1, "sdig": 1}
    packed = {k: np.pad(v, [(0, 0), (0, pad)] if k in nibbles else
                        [(0, pad)] + [(0, 0)] * (v.ndim - 1))
              for k, v in packed.items()}
    out = tv.launch_lanes(mesh, packed, lambda d, t: sr_verify(
        t["ab"], t["rb"], t["kdig"], t["sdig"], t["a_pre"], t["r_pre"],
        t["s_ok"], comb_table(t["ab"].device)), lane_axis=nibbles)
    return kernels.readback(out)[:n] & well_formed
