"""Expanded validator sets: per-key comb tables kept on the device.

In consensus the same validators sign every block, so the work that
depends only on a public key A — its decompression and the multiples
of -A — is done once per validator set and reused for every commit.
For each key the table holds the signed-digit comb

    T[v, w, j] = j * 16^w * (-A_v)      (w < 69, j <= 8)

and a verify recodes its challenge to digits d_w in [-8, 8], gathers
entry |d_w| per window and negates it by the digit's sign: [k](-A)
costs 69 point adds and no doublings.

Kernels (csrc/), each beside its plain PyTorch version:

- K1 ``build_tables``: decompress every key and write its table
  (reference: tendermint_tpu/crypto/tpu/expanded.py ``_builder``).
- K3 ``xverify``: verify lanes against the tables (reference:
  ``_xcore``), the messages given as rows or, in the structured form,
  assembled inside the launch from commit templates plus a per-lane
  timestamp patch (K2's function, reference ``assemble_core``, traced
  into ``_skernel``; plain version ``assemble_plain``).
- K5 ``shard_verify``: the same kernel (csrc/xverify.cu) on one shard
  of key-range-sharded tables, launched once per mesh entry on its
  device and stream (reference: ``_xkernel_sharded``,
  ``_skernel_sharded``).

On a mesh (verify.effective_mesh) a set's tables either replicate, and
each launch splits its lanes evenly over the entries, or, above the
shard crossover, split by key range: entry d holds the tables of keys
[d*K, (d+1)*K), and each launch routes every lane to its key's home
entry, so a lane's table reads stay on its device.

Layout: an entry is 4 coordinates x the selected field's limbs
(crypto/cuda/fieldsel.py): 10 int32 (160 B, 99,360 B a key, 1.02 GB
for 10,240 keys) or, under TM_TPU_FIELD=f32, 32 float32 (512 B,
317,952 B a key, 3.26 GB for 10,240 keys). The reference pads its
88-int i32 entry to a 128-int TPU row; its f32 entry fills the row.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ...device import default_device
from . import edwards as ed
from .fieldsel import F as fe
from . import kernels
from . import scalar as sc
from . import sha512 as sh
from . import verify as tv

logger = logging.getLogger("crypto.cuda.expanded")

_WINDOWS = 69  # scalar.DIGITS_K: folded challenge < 2^271
_ENTRIES = 9   # signed digits: |d| in 0..8
TABLE_BYTES_PER_KEY = _WINDOWS * _ENTRIES * 4 * fe.NLIMB * 4  # 4-byte limbs
# Expansion pays off only when the same set verifies repeatedly and the
# batch is big enough for the device path.
MIN_EXPAND = 128
# Keys the CPU (plain-version) path expands at most — the reference's
# CPU-backend policy (tendermint_tpu/crypto/tpu/expanded.py
# _CPU_MAX_KEYS), so both route commits at the same points.
_CPU_MAX_KEYS = 2048

_PATCH_W = 24
_PRE_W = 128
_SUF_W = 64

# -- key-range sharding crossover -----------------------------------------
#
# Sets of at most this many keys replicate their tables over the mesh;
# larger sets split them by key range. None: the single-device table
# budget (replicate while a set fits one device, shard beyond). Set by
# config.apply_mesh ([mesh] expanded_shard_crossover_keys) or
# TM_TPU_SHARD_CROSSOVER.
_SHARD_CROSSOVER: int | None = None


def set_shard_crossover(n: int | None) -> None:
    """Sets of at most n keys replicate their tables; larger ones shard
    by key range. None or 0 restores the default (the single-device
    budget)."""
    global _SHARD_CROSSOVER
    _SHARD_CROSSOVER = int(n) if n else None


def _single_chip_max_keys() -> int:
    """The largest set whose tables fit one device. On a GPU: the
    _CACHE_MAX cached sets share half of the card's memory
    (torch.cuda.mem_get_info), at TABLE_BYTES_PER_KEY plus the key row
    each. On the CPU: the reference's CPU cap."""
    dev = default_device()
    if dev.type != "cuda":
        return _CPU_MAX_KEYS
    _free, total = torch.cuda.mem_get_info(dev)
    return int(total // 2 // _CACHE_MAX // (TABLE_BYTES_PER_KEY + 33))


def shard_crossover_keys() -> int:
    """set_shard_crossover's value, else TM_TPU_SHARD_CROSSOVER's (a
    malformed value is logged and ignored: the environment is the
    lenient surface, the config the strict one), else the single-device
    budget."""
    if _SHARD_CROSSOVER is not None:
        return _SHARD_CROSSOVER
    env = os.environ.get("TM_TPU_SHARD_CROSSOVER")
    if env:
        try:
            val = int(env)
        except ValueError:
            logger.warning("ignoring malformed TM_TPU_SHARD_CROSSOVER=%r",
                           env)
            val = 0
        if val:  # 0 means the default here too, as in the config
            return val
    return _single_chip_max_keys()


# -- K1: comb-table build ------------------------------------------------


def build_tables_plain(akeys: torch.Tensor):
    """Plain PyTorch version of K1 (csrc/build_tables.cu).
    (V, 32) uint8 keys -> ((V, 69, 9, 4, NLIMB) tables in the table
    dtype, (V,) bool ok)."""
    v = akeys.shape[0]
    pt, ok = ed.decompress_bytes(akeys.to(torch.int64).T)
    base = ed.neg(pt)
    rows = []
    for _ in range(_WINDOWS):
        entries = [ed.identity(v, akeys.device), base]
        for _j in range(_ENTRIES - 2):
            entries.append(ed.add(entries[-1], base))
        rows.append(torch.stack([torch.stack(list(e)) for e in entries]))
        for _k in range(4):
            base = ed.double(base)
    tables = torch.stack(rows)  # (69, 9, 4, NLIMB, V)
    return tables.permute(4, 0, 1, 2, 3).to(fe.TABLE_DTYPE).contiguous(), ok


def build_tables(akeys: torch.Tensor):
    """K1 wrapper: plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (or KernelError). One launch for the whole set."""
    if akeys.device.type == "cpu":
        return build_tables_plain(akeys)
    dev = akeys.device
    v = akeys.shape[0]
    kernels.require(akeys, "akeys", torch.uint8, (v, 32), dev)
    tables = torch.empty((v, _WINDOWS, _ENTRIES, 4, fe.NLIMB),
                         dtype=fe.TABLE_DTYPE, device=dev)
    ok = torch.empty(v, dtype=torch.bool, device=dev)
    rc = kernels.lib().tm_build_tables(akeys.data_ptr(), tables.data_ptr(),
                                       ok.data_ptr(), v,
                                       kernels.stream_ptr(dev))
    kernels.check(rc, "build_tables")
    build_tables.launches += 1
    return tables, ok


build_tables.launches = 0


# -- K2: sign-bytes assembly, inside K3/K5's structured form ------------


def assemble_plain(pre, pre_len, suf, suf_len, patch, split, patch_len,
                   group, width: int):
    """Plain PyTorch version of K2, which runs inside K3/K5's structured
    form (csrc/xverify.cu, sign_bytes.cuh) and K7: (N, width) uint8
    message rows (sign bytes + SHA-512 tail for a 64-byte prefix) and
    (N,) int32 block counts."""
    dev = patch.device
    j = torch.arange(width, device=dev)[None, :]
    g = group.to(torch.int64)
    a = split.to(torch.int64)[:, None]
    b = (patch_len.to(torch.int64) - split.to(torch.int64))[:, None]
    c1 = a + pre_len.to(torch.int64)[g][:, None]
    c2 = c1 + b
    c3 = c2 + suf_len.to(torch.int64)[g][:, None]  # = mlen
    pre_g = pre[g].to(torch.int64)
    suf_g = suf[g].to(torch.int64)
    patch_i = patch.to(torch.int64)

    def gat(src, col):
        return torch.gather(src, 1, col.clamp(0, src.shape[1] - 1)
                            .expand(src.shape[0], width))

    msg = torch.where(
        j < a, gat(patch_i, j),
        torch.where(j < c1, gat(pre_g, j - a),
                    torch.where(j < c2, gat(patch_i, a + (j - c1)),
                                torch.where(j < c3, gat(suf_g, j - c2),
                                            torch.zeros_like(j)))))
    msg = torch.where(j == c3, torch.full_like(msg, 0x80), msg)
    nblocks = (64 + c3 + 17 + 127) // 128
    bitlen = (64 + c3) * 8
    k = 15 - (j - (nblocks * 128 - 16 - 64))
    lenbyte = torch.where(k < 4, (bitlen >> (8 * k.clamp(0, 3))) & 0xFF,
                          torch.zeros_like(k))
    msg = torch.where((k >= 0) & (k < 16), lenbyte, msg)
    return msg.to(torch.uint8), nblocks[:, 0].to(torch.int32)


# -- K3 and K5: verify against the tables (one kernel, csrc/xverify.cu) --


def xverify_plain(idx, akeys, sb, msg, nblocks, s_ok, key_ok, tables,
                  btab) -> torch.Tensor:
    """Plain PyTorch version of K3 and K5 (csrc/xverify.cu) on message
    rows -> (N,) bool."""
    n = idx.shape[0]
    dev = idx.device
    ki = idx.to(torch.int64)
    ab = akeys[ki]
    full = torch.cat([sb[:, :32], ab, msg], dim=1)
    digest = sh.compress_blocks(sh.bytes_to_words(full), nblocks)
    digk = sc.recode_signed(sc.fold_digest(sh.digest_bytes_le(digest)).flip(0))
    s_rows = sb.to(torch.int64).T
    digs = sc.bytes_to_nibbles(s_rows[32:])
    digs = torch.cat([digs, torch.zeros((_WINDOWS - 64, n), dtype=torch.int64,
                                        device=dev)])
    R, r_ok = ed.decompress_bytes(s_rows[:32])
    neg_r = ed.neg(R)
    acc_a = acc_b = ed.identity(n, dev)
    for w in range(_WINDOWS):
        e = tables[ki, w, digk[w].abs()].to(fe.DTYPE).permute(1, 2, 0)
        neg = (digk[w] < 0)[None]
        qx = torch.where(neg, fe.neg(e[0]), e[0])
        qt = torch.where(neg, fe.neg(e[3]), e[3])
        acc_a = ed.add(acc_a, ed.Point(qx, e[1], e[2], qt))
        acc_b = ed.add_z1(acc_b, *ed.select_const(btab[w], digs[w]))
    v = ed.add(ed.add(acc_a, acc_b), neg_r)
    for _ in range(3):
        v = ed.double(v)
    return ed.is_identity(v) & r_ok & s_ok & key_ok[ki]


def shard_verify_plain(idx, akeys, sb, s_ok, key_ok, tables, btab, *,
                       msg=None, nblocks=None, templates=None,
                       patches=None, width: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K3 and K5 (csrc/xverify.cu) in either
    form: key indices idx (n,) i32 into akeys (K, 32) u8, key_ok (K,)
    bool and tables (K, 69, 9, 4, NLIMB) (the set's, or one shard's
    key range), signature rows sb (n, 64) u8, s_ok (n,) bool, the comb
    btab. The messages are either msg (n, W) u8 rows with nblocks (n,)
    i32, or assembled from templates (pre, pre_len, suf, suf_len) and
    per-lane patches (patch, split, patch_len, group) at `width`:
    assemble_plain, then xverify_plain. -> (n,) bool."""
    if templates is not None:
        msg, nblocks = assemble_plain(*templates, *patches, width)
    return xverify_plain(idx, akeys, sb, msg, nblocks, s_ok, key_ok, tables,
                         btab)


def xverify(idx, akeys, sb, s_ok, key_ok, tables, btab, *, msg=None,
            nblocks=None, templates=None, patches=None,
            width: int = 0) -> torch.Tensor:
    """K3 wrapper (arguments as shard_verify_plain, over the whole set's
    tables): the plain version for CPU tensors, one launch of the CUDA
    kernel for CUDA tensors (or KernelError), on the current device and
    stream. In the structured form the sign bytes are assembled inside
    the launch: no K2 launch, no message tensor."""
    if (msg is None) == (templates is None):
        raise ValueError("give msg and nblocks, or templates and patches")
    if idx.device.type == "cpu":
        return shard_verify_plain(idx, akeys, sb, s_ok, key_ok, tables, btab,
                                  msg=msg, nblocks=nblocks,
                                  templates=templates, patches=patches,
                                  width=width)
    out = _xverify_launch(idx, akeys, sb, s_ok, key_ok, tables, btab, msg,
                          nblocks, templates, patches, width)
    xverify.launches += 1
    return out


xverify.launches = 0


def shard_verify(idx, akeys, sb, s_ok, key_ok, tables, btab, *, msg=None,
                 nblocks=None, templates=None, patches=None,
                 width: int = 0) -> torch.Tensor:
    """K5 wrapper: K3's kernel on one shard's key range (arguments as
    shard_verify_plain), counted here and not under K3: the plain
    version for CPU tensors, one launch for CUDA tensors (or
    KernelError), on the current device and stream."""
    if (msg is None) == (templates is None):
        raise ValueError("give msg and nblocks, or templates and patches")
    if idx.device.type == "cpu":
        return shard_verify_plain(idx, akeys, sb, s_ok, key_ok, tables, btab,
                                  msg=msg, nblocks=nblocks,
                                  templates=templates, patches=patches,
                                  width=width)
    out = _xverify_launch(idx, akeys, sb, s_ok, key_ok, tables, btab, msg,
                          nblocks, templates, patches, width)
    shard_verify.launches += 1
    return out


shard_verify.launches = 0


def _xverify_launch(idx, akeys, sb, s_ok, key_ok, tables, btab, msg,
                    nblocks, templates, patches, width) -> torch.Tensor:
    """One tm_xverify launch on CUDA tensors (K3's and K5's; each
    wrapper counts its own launches)."""
    dev = idx.device
    n = idx.shape[0]
    k = akeys.shape[0]
    kernels.require(idx, "idx", torch.int32, (n,), dev)
    kernels.require(akeys, "akeys", torch.uint8, (k, 32), dev)
    kernels.require(sb, "sb", torch.uint8, (n, 64), dev)
    kernels.require(s_ok, "s_ok", torch.bool, (n,), dev)
    kernels.require(key_ok, "key_ok", torch.bool, (k,), dev)
    kernels.require(tables, "tables", fe.TABLE_DTYPE,
                    (k, _WINDOWS, _ENTRIES, 4, fe.NLIMB), dev)
    kernels.require(btab, "btab", fe.TABLE_DTYPE, (_WINDOWS, 16, 3, fe.NLIMB),
                    dev)
    ptrs = [None] * 10
    if msg is not None:
        width = msg.shape[1]
        kernels.require(msg, "msg", torch.uint8, (n, width), dev)
        kernels.require(nblocks, "nblocks", torch.int32, (n,), dev)
        ptrs[:2] = msg.data_ptr(), nblocks.data_ptr()
    else:
        pre, pre_len, suf, suf_len = templates
        g = pre.shape[0]
        kernels.require(pre, "pre", torch.uint8, (g, _PRE_W), dev)
        kernels.require(pre_len, "pre_len", torch.int32, (g,), dev)
        kernels.require(suf, "suf", torch.uint8, (g, _SUF_W), dev)
        kernels.require(suf_len, "suf_len", torch.int32, (g,), dev)
        patch, split, patch_len, group = patches
        kernels.require(patch, "patch", torch.uint8, (n, _PATCH_W), dev)
        for name, t in (("split", split), ("patch_len", patch_len),
                        ("group", group)):
            kernels.require(t, name, torch.int32, (n,), dev)
        ptrs[2:] = [t.data_ptr() for t in (*templates, *patches)]
    out = torch.empty(n, dtype=torch.bool, device=dev)
    rc = kernels.lib().tm_xverify(
        idx.data_ptr(), akeys.data_ptr(), sb.data_ptr(), s_ok.data_ptr(),
        key_ok.data_ptr(), tables.data_ptr(), btab.data_ptr(), *ptrs, width,
        n, out.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(rc, "xverify")
    return out


class ExpandedKeys:
    """Device-resident comb tables for a fixed list of ed25519 pubkeys.

    Three placements, chosen at build from the mesh (verify.effective_mesh)
    and the set's size: no mesh — one copy on ``device``; a mesh and at
    most shard_crossover_keys() keys (and no more than one device's
    budget) — the tables replicate on every entry (``shards`` holds each
    entry's (akeys, tables, key_ok); ``.to`` of a tensor onto the device
    it is on returns it, so a logical mesh on one card holds one copy)
    and a launch of _SHARD_MIN lanes or more splits its lanes evenly;
    above that — the tables split by key range (``sharded``: entry d's
    ``shards[d]`` holds keys [d*K, (d+1)*K), the set padded with zero
    keys to D*K, whose key_ok is False) and a launch routes each lane to
    its key's entry, one K5 launch per entry. Without a mesh, a set
    beyond one device's budget is refused (ValueError)."""

    # Message widths (bytes after the 64-byte R||A prefix) of the
    # structured path: 2- and 4-block SHA inputs. Every realistic vote
    # fits in 192 (mlen <= 175); 448 covers long chain ids.
    _S_WIDTHS = (192, 448)
    # Template groups per launch (types/sign_batch.py MAX_GROUPS).
    _S_GROUPS = 32
    # Fields of the structured form every entry gets whole.
    _S_REPL = ("pre", "pre_len", "suf", "suf_len")
    # One copy on one device until a build places it on a mesh.
    mesh = None
    shards = None
    sharded = False

    def __init__(self, pubkeys: list[bytes], device=None):
        self.pubkeys = tuple(bytes(p) for p in pubkeys)
        if not all(len(p) == 32 for p in self.pubkeys):
            raise ValueError("ed25519 pubkeys must be 32 bytes")
        self.device = default_device() if device is None else torch.device(device)
        a_raw = np.frombuffer(b"".join(self.pubkeys), np.uint8).reshape(-1, 32)
        v = len(self.pubkeys)
        self.n_shards = 1
        self.keys_per_shard = v
        self._reshard_lock = threading.Lock()
        # Built over the EFFECTIVE mesh (the base mesh minus evicted
        # entries): a build while degraded places over the survivors,
        # and _maybe_reshard() moves it when that set changes.
        self.mesh = tv.effective_mesh()
        if _splits(v, self.mesh):
            self._build_sharded(a_raw)
            return
        budget = _single_chip_max_keys()
        if v > budget:
            raise ValueError(
                f"{v}-key expanded build exceeds the single-chip table "
                f"budget ({budget} keys) and no mesh is available for "
                "key-range sharding")
        self.akeys = torch.from_numpy(a_raw.copy()).to(self.device)
        self.tables, self.key_ok = build_tables(self.akeys)
        self._replicate()

    def _replicate(self) -> None:
        """``shards``: each mesh entry's copy of the tables, else the one
        copy."""
        self.shards = [(self.akeys.to(dev), self.tables.to(dev),
                        self.key_ok.to(dev))
                       for dev in self.mesh or (self.device,)]

    def _build_sharded(self, a_raw: np.ndarray) -> None:
        """Key-range-sharded build: pad the set to D*K keys and build each
        K-key range with one K1 launch on its home entry."""
        mesh = self.mesh
        d_n = len(mesh)
        v = a_raw.shape[0]
        k = -(-v // d_n)
        padded = np.zeros((d_n * k, 32), np.uint8)
        padded[:v] = a_raw
        real = (np.arange(d_n * k) < v).reshape(d_n, k)

        def one(d, dev):
            akeys = torch.from_numpy(padded[d * k:(d + 1) * k].copy()).to(dev)
            return (akeys, *build_tables(akeys))

        built = tv.run_shards(mesh, one)
        # padding keys are never addressed (indices are checked against
        # the set) and pad lanes are dropped by the slot map; their
        # key_ok is False all the same
        self._set_shards([(a, t, ok & torch.from_numpy(real[d]).to(ok.device))
                          for d, (a, t, ok) in enumerate(built)], k)

    def _set_shards(self, shards, k: int) -> None:
        self.shards = shards
        self.sharded = True
        self.n_shards = len(shards)
        self.keys_per_shard = k
        self.akeys = self.tables = self.key_ok = None

    def _maybe_reshard(self) -> None:
        """Live reshard: when the effective mesh no longer matches the
        mesh this set is placed on — an entry was just evicted, or a
        half-open probe re-admitted one — move the placement onto the
        surviving entries in place. Key-range-sharded tables rebuild
        D -> D' ranges from the kept key bytes (one K1 launch a new
        range); replicated tables are re-placed. Verdicts do not change:
        same keys, same kernels. (The reference also releases the old
        placement's bytes from its HBM registry; the port has none.)
        The identity check is the lock-free fast path."""
        if self.mesh is None:
            return
        want = tv.effective_mesh()
        if want is self.mesh:
            return
        with self._reshard_lock:
            want = tv.effective_mesh()
            if want is self.mesh:
                return
            if want is None:
                # fewer than two survivors: keep the placement; the
                # escalation (every entry out) is mark_device_failed's
                return
            if want.names == self.mesh.names:
                self.mesh = want  # the same entries, another object
                return
            t0 = time.perf_counter()
            self.mesh = want
            if self.sharded:
                self._build_sharded(np.frombuffer(
                    b"".join(self.pubkeys), np.uint8).reshape(-1, 32))
            else:
                self._replicate()
            self.last_reshard_s = time.perf_counter() - t0
            logger.warning("live reshard: %d-key tables placed over %d "
                           "entries in %.3fs", len(self.pubkeys),
                           len(want), self.last_reshard_s)

    @classmethod
    def from_reference_arrays(cls, pubkeys, tables, key_ok, device=None):
        """Carry a set built by the reference (under the same
        TM_TPU_FIELD) over. ``tables`` are its (V*69*9, 128) rows (4
        coordinates of REF_NLIMB limbs, then padding: 22 twelve-bit
        int32 limbs, or 32 float32 limbs, the port's own under f32) and
        ``key_ok`` its (V,) flags; or, from a key-range-sharded build,
        (D, K*69*9, 128) rows and (D, K) flags, which become the
        per-shard blocks on this port's mesh (it must have D entries).
        Each entry is re-encoded in this port's limbs
        (fe.from_reference)."""
        self = cls.__new__(cls)
        self.pubkeys = tuple(bytes(p) for p in pubkeys)
        self._reshard_lock = threading.Lock()
        v = len(self.pubkeys)
        self.device = default_device() if device is None else torch.device(device)
        rows = np.asarray(tables)
        ok = np.asarray(key_ok, bool)
        a_raw = np.frombuffer(b"".join(self.pubkeys), np.uint8).reshape(-1, 32)
        self.mesh = tv.effective_mesh()
        per_key = _WINDOWS * _ENTRIES
        payload = 4 * fe.REF_NLIMB
        if rows.ndim == 3:
            d_n, k = ok.shape
            if self.mesh is None or len(self.mesh) != d_n:
                raise ValueError(f"a {d_n}-shard reference build needs a "
                                 f"mesh of {d_n} entries")
            if rows.shape != (d_n, k * per_key, 128) or d_n * k < v:
                raise ValueError(f"reference tables shape {rows.shape}")
            conv = fe.from_reference(rows[:, :, :payload].reshape(
                d_n, k, _WINDOWS, _ENTRIES, 4, fe.REF_NLIMB))
            padded = np.zeros((d_n * k, 32), np.uint8)
            padded[:v] = a_raw
            self._set_shards([
                (torch.from_numpy(padded[d * k:(d + 1) * k].copy()).to(dev),
                 torch.from_numpy(conv[d]).to(dev),
                 torch.from_numpy(ok[d].copy()).to(dev))
                for d, dev in enumerate(self.mesh)], k)
            return self
        if rows.shape != (v * per_key, 128):
            raise ValueError(f"reference tables shape {rows.shape}")
        conv = fe.from_reference(rows[:, :payload].reshape(
            v, _WINDOWS, _ENTRIES, 4, fe.REF_NLIMB))
        self.n_shards = 1
        self.keys_per_shard = v
        self.akeys = torch.from_numpy(a_raw.copy()).to(self.device)
        self.tables = torch.from_numpy(conv).to(self.device)
        self.key_ok = torch.from_numpy(ok.copy()).to(self.device)
        self._replicate()
        return self

    def __len__(self) -> int:
        return len(self.pubkeys)

    def _check_idx(self, indices, n_sigs) -> np.ndarray:
        n = len(indices)
        if n_sigs != n:
            raise ValueError("one signature per lane")
        idx = np.asarray(indices, np.int32)
        if n > tv._MAX_BATCH:
            raise ValueError("split huge batches at the call site")
        if idx.min() < 0 or idx.max() >= len(self.pubkeys):
            raise ValueError("key index out of range")
        return idx

    @staticmethod
    def _sig_rows(sigs, pad: int) -> tuple[np.ndarray, np.ndarray]:
        """(bucket, 64) signature rows + per-lane well-formedness.

        Per-lane length check. An aggregate total-length shortcut
        would be unsound: two adjacent malformed sigs of 63+65 bytes
        cancel out and every following lane's bytes shift."""
        n = len(sigs)
        lens = np.fromiter(map(len, sigs), np.int64, count=n)
        well_formed = lens == 64
        if not well_formed.all():
            sigs = [s if ok else b"\0" * 64
                    for s, ok in zip(sigs, well_formed)]
        joined = b"".join(sigs) + b"\0" * (64 * pad)
        return (np.frombuffer(joined, np.uint8).reshape(n + pad, 64),
                well_formed)

    _bucket = staticmethod(tv.lane_bucket)

    def _prepare(self, indices, msgs, sigs):
        """Host side of verify: validate, pad to a bucket, pack bytes.
        Sharded tables take no padding here: _route buckets per entry
        (pad lanes here would all home on entry 0 and inflate every
        entry's bucket)."""
        n = len(indices)
        if len(msgs) != n:
            raise ValueError("one message per lane")
        idx = self._check_idx(indices, len(sigs))
        pad = 0 if self.sharded else self._bucket(n) - n
        sig_raw, well_formed = self._sig_rows(sigs, pad)
        if pad:
            idx = np.concatenate([idx, np.zeros(pad, np.int32)])
            msgs = list(msgs) + [b""] * pad
        return idx, tv.pack_sig_msg(sig_raw, msgs), well_formed

    def _shard_args(self, idx, fields, repl_keys=()):
        """Lane sharding over replicated tables: when there is a mesh and
        the bucket is at least _SHARD_MIN lanes, pad the per-lane fields
        (not the `repl_keys` ones, which every entry gets whole) with
        zero lanes (s_ok False; dropped by the caller's [:n]) to a
        multiple of the mesh size. Returns (idx, fields, shard?)."""
        bucket = idx.shape[0]
        if self.mesh is None or bucket < tv._SHARD_MIN:
            return idx, fields, False
        pad = tv.mesh_lane_pad(bucket, self.mesh) - bucket
        if pad:
            idx = np.concatenate([idx, np.zeros(pad, np.int32)])
            fields = {k: v if k in repl_keys else np.pad(
                v, ((0, pad),) + ((0, 0),) * (v.ndim - 1))
                for k, v in fields.items()}
        return idx, fields, True

    def _route(self, idx, per_lane: dict):
        """Lane -> home entry routing (key-range-sharded tables):
        stable-sort the lanes by their key's entry, pad every entry to a
        common bucket n_local = _bucket(largest entry's count), and
        rebase indices into the entry's key range. Returns the local
        indices (D, n_local), the routed per-lane arrays (D, n_local,
        ...) and the slot map that restores the original lane order
        from the flat (D * n_local,) verdicts. Pad lanes carry local
        index 0 and zero signatures (s_ok False). Commit lanes are
        distinct validators, so an entry runs ~N/D lanes; a batch whose
        lanes all fall in one range pads every entry to the whole
        batch."""
        d_n, k = self.n_shards, self.keys_per_shard
        bucket = idx.shape[0]
        home = idx // k
        order = np.argsort(home, kind="stable")
        counts = np.bincount(home, minlength=d_n)
        n_local = self._bucket(max(int(counts.max()), 1))
        local_idx = np.zeros((d_n, n_local), np.int32)
        routed = {name: np.zeros((d_n, n_local) + a.shape[1:], a.dtype)
                  for name, a in per_lane.items()}
        slot = np.zeros(bucket, np.int64)
        off = 0
        for d in range(d_n):
            sel = order[off:off + counts[d]]
            local_idx[d, :counts[d]] = idx[sel] - d * k
            for name, a in per_lane.items():
                routed[name][d, :counts[d]] = a[sel]
            slot[sel] = d * n_local + np.arange(counts[d])
            off += counts[d]
        tv.count_shard_lanes(self.mesh, n_local * d_n)
        return local_idx, routed, slot

    def _k5_args(self, d, dev, lidx, routed, templates=None, width=0):
        """shard_verify's arguments for entry d of a routed launch: its
        lanes uploaded to `dev`, its key range, and the message form
        (the replicated `templates` and `width` of the structured form,
        else the routed msg and nblocks)."""
        t = tv.to_device({k: v[d] for k, v in routed.items()} |
                         {"idx": lidx[d]}, dev)
        akeys, tables, key_ok = self.shards[d]
        if templates is None:
            form = dict(msg=t["msg"], nblocks=t["nblocks"])
        else:
            form = dict(templates=tuple(x.to(dev) for x in templates),
                        patches=(t["patch"], t["split"], t["patch_len"],
                                 t["group"]), width=width)
        return (t["idx"], akeys, t["sb"], t["s_ok"], key_ok, tables,
                tv._btab(dev)), form

    def _sharded_launch(self, idx, per_lane, templates=None,
                        width=0) -> torch.Tensor:
        """One K5 launch per entry over the routed lanes, on the entry's
        device and stream; the verdicts back in lane order."""
        lidx, routed, slot = self._route(idx, per_lane)

        def one(d, dev):
            args, form = self._k5_args(d, dev, lidx, routed, templates, width)
            return shard_verify(*args, **form)

        return _routed_verdicts(tv.run_shards(self.mesh, one), slot)

    def _launch(self, idx, packed) -> torch.Tensor:
        if self.sharded:
            return self._sharded_launch(idx, packed)
        idx, packed, shard = self._shard_args(idx, packed)

        def launch(d, t):
            return self._xverify(d, t, msg=t["msg"], nblocks=t["nblocks"])

        if shard:
            return tv.launch_lanes(self.mesh, dict(packed, idx=idx), launch)
        return launch(0, tv.to_device(dict(packed, idx=idx), self.device))

    def _xverify(self, d, t, **form) -> torch.Tensor:
        """One K3 launch over lanes `t` on entry d's copy of the tables,
        the messages in `form` (xverify's keywords)."""
        akeys, tables, key_ok = self.shards[d]
        return xverify(t["idx"], akeys, t["sb"], t["s_ok"], key_ok, tables,
                       tv._btab(t["idx"].device), **form)

    def verify(self, indices, msgs, sigs) -> np.ndarray:
        """Verify (self.pubkeys[indices[i]], msgs[i], sigs[i]) lanes;
        verdicts identical to verify.verify_batch on the same triples."""
        n = len(indices)
        if n == 0:
            return np.zeros(0, bool)
        self._maybe_reshard()
        idx, packed, well_formed = self._prepare(indices, msgs, sigs)
        full = kernels.readback(self._launch(idx, packed))
        return full[:n] & well_formed

    def _prepare_structured(self, indices, sbatch, sigs):
        n = len(indices)
        if len(sbatch) != n:
            raise ValueError("one structured message per lane")
        idx = self._check_idx(indices, len(sigs))
        # Host self-check: lane 0's structured reassembly must equal its
        # independently computed canonical sign bytes.
        if sbatch.host_assemble(0) != sbatch.anchor_bytes():
            raise ValueError("structured sign-bytes self-check failed")
        max_len = sbatch.max_msg_len()
        width = next((w for w in self._S_WIDTHS if max_len <= w - 17), None)
        if width is None:
            raise ValueError("sign bytes too long for structured path")
        k, pw = sbatch.pre.shape
        sw = sbatch.suf.shape[1]
        kp = self._S_GROUPS
        if k > kp or pw > _PRE_W or sw > _SUF_W:
            raise ValueError("templates too large for structured path")
        pad = 0 if self.sharded else self._bucket(n) - n
        sig_raw, well_formed = self._sig_rows(sigs, pad)

        def padded(a, rows):
            return np.pad(a, ((0, rows),) + ((0, 0),) * (a.ndim - 1))

        if pad:
            idx = np.concatenate([idx, np.zeros(pad, np.int32)])
        fields = dict(
            sb=sig_raw,
            s_ok=tv.s_range_ok(sig_raw),
            pre=np.pad(sbatch.pre, ((0, kp - k), (0, _PRE_W - pw))),
            pre_len=padded(sbatch.pre_len, kp - k),
            suf=np.pad(sbatch.suf, ((0, kp - k), (0, _SUF_W - sw))),
            suf_len=padded(sbatch.suf_len, kp - k),
            patch=padded(sbatch.patch, pad),
            split=padded(sbatch.split, pad),
            patch_len=padded(sbatch.patch_len, pad),
            group=padded(sbatch.group, pad),
        )
        return idx, fields, well_formed, width

    def _launch_structured(self, idx, fields, width) -> torch.Tensor:
        dev0 = self.device if self.mesh is None else self.mesh[0]
        tpl = tv.to_device({k: fields[k] for k in self._S_REPL}, dev0)
        templates = tuple(tpl[k] for k in self._S_REPL)
        per_lane = {k: v for k, v in fields.items() if k not in self._S_REPL}
        if self.sharded:
            return self._sharded_launch(idx, per_lane, templates=templates,
                                        width=width)
        idx, per_lane, shard = self._shard_args(idx, per_lane)

        def structured(d, t):
            dev = t["idx"].device
            return self._xverify(
                d, t, templates=tuple(x.to(dev) for x in templates),
                patches=(t["patch"], t["split"], t["patch_len"], t["group"]),
                width=width)

        if shard:
            return tv.launch_lanes(self.mesh, dict(per_lane, idx=idx),
                                   structured)
        return structured(0, tv.to_device(dict(per_lane, idx=idx),
                                          self.device))

    def verify_structured(self, indices, sbatch, sigs) -> np.ndarray:
        """verify() for commit votes in structured form: identical
        verdicts to verify(indices, sbatch.materialize(), sigs), with
        the sign bytes assembled on the device, inside the verify launch
        (K3's structured form, or K5's on sharded tables: one launch a
        device), from the commit's templates and per-lane timestamp
        patches."""
        n = len(indices)
        if n == 0:
            return np.zeros(0, bool)
        self._maybe_reshard()
        idx, fields, well_formed, width = self._prepare_structured(
            indices, sbatch, sigs)
        full = kernels.readback(self._launch_structured(idx, fields, width))
        return full[:n] & well_formed


def _routed_verdicts(outs, slot: np.ndarray) -> torch.Tensor:
    """The entries' (n_local,) verdicts of a routed launch, gathered and
    put back in the caller's lane order by the slot map (the
    reference's _RoutedVerdicts, gathered at once)."""
    flat = tv.gather(outs)
    return flat[torch.from_numpy(slot).to(flat.device)]


# -- process-wide LRU of expanded sets (one active + one in transition) --

_CACHE: OrderedDict[tuple, ExpandedKeys] = OrderedDict()
_CACHE_MAX = 2
# _CACHE_LOCK guards only the dict. Builds are serialized per key via
# _BUILDS events, so a background warm racing a commit verify never
# builds the same table twice, and a cache hit for another set never
# waits behind a build.
_CACHE_LOCK = threading.Lock()
_BUILDS: dict[tuple, threading.Event] = {}


def max_keys() -> int:
    """Largest validator set the expanded tables serve: the single-device
    budget (_single_chip_max_keys) times the number of distinct devices
    of the mesh, since above the crossover the tables split by key
    range. A logical mesh (entries repeating one card) and a CPU mesh
    give no lift: their shards share one memory."""
    base = _single_chip_max_keys()
    mesh = tv._mesh()
    if mesh is None or default_device().type != "cuda":
        return base
    return base * len(set(mesh))


def _splits(n_keys: int, mesh) -> bool:
    """Whether a set of n_keys keys built on `mesh` splits by key range:
    above the crossover, or above one device's budget whatever the
    crossover says (a crossover set past the budget must not refuse
    every commit)."""
    return mesh is not None and n_keys > min(shard_crossover_keys(),
                                             _single_chip_max_keys())


def _placement(n_keys: int) -> tuple:
    """The BASE placement of a set of n_keys keys: the default device,
    the base mesh (verify._mesh, not the effective one) and whether it
    splits on it. A set's cache key holds this and its keys only, so an
    eviction or a re-admission reshards the cached object in place
    (_maybe_reshard) instead of building it anew; another mesh or
    crossover regime set by the caller is another placement."""
    mesh = tv._mesh()
    return (str(default_device()),
            None if mesh is None else mesh.names,
            _splits(n_keys, mesh))


def get_expanded(pubkeys: list[bytes]) -> ExpandedKeys:
    dev = default_device()
    key = (_placement(len(pubkeys)), hashlib.sha256(b"".join(pubkeys)).digest())
    while True:
        with _CACHE_LOCK:
            exp = _CACHE.get(key)
            if exp is not None:
                _CACHE.move_to_end(key)
                return exp
            ev = _BUILDS.get(key)
            if ev is None:
                ev = threading.Event()
                _BUILDS[key] = ev
                break  # this thread builds
        ev.wait()  # another thread builds this set: wait, then re-check
    try:
        exp = ExpandedKeys(pubkeys, device=dev)
        with _CACHE_LOCK:
            _CACHE[key] = exp
            while len(_CACHE) > _CACHE_MAX:
                _CACHE.popitem(last=False)
        return exp
    finally:
        with _CACHE_LOCK:
            _BUILDS.pop(key, None)
        ev.set()


class _Warm(threading.Thread):
    """The warm thread. A failed build is logged, and join() re-raises
    it, so a caller that waits for the tables sees the failure."""

    def __init__(self, pubkeys: list[bytes]):
        super().__init__(name="expanded-warm", daemon=True)
        self._pubkeys = pubkeys
        self.error: BaseException | None = None

    def run(self) -> None:
        try:
            get_expanded(self._pubkeys)
        except BaseException as e:  # noqa: BLE001 - kept for join()
            self.error = e
            logger.exception("background expanded-table warm failed "
                             "(%d keys)", len(self._pubkeys))

    def join(self, timeout: float | None = None) -> None:
        super().join(timeout)
        if self.error is not None:
            raise self.error


def warm_async(pubkeys: list[bytes]) -> threading.Thread:
    """Build (or touch) a set's tables in a background thread, so the
    first commit verify after a validator-set change does not pay the
    table build inline. Returns the started thread, whose join()
    re-raises a failed build; read the tables through get_expanded,
    which waits for an in-flight build."""
    t = _Warm(pubkeys)
    t.start()
    return t
