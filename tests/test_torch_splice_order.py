"""K6's splice and clear (csrc/splice.cu), and so K8's, in the kernels'
order of work, on the CPU.

A plain model of each kernel's thread map is held to the port's plain
versions (``resident.splice_plain``, ``clear_plain``,
``mesh_clear_plain``) and to the JAX package's programs
(``_splice_fn``, ``_clear_fn``, ``_mesh_clear_fn``, jitted on the XLA
CPU backend):

- k_splice: eight threads a row; thread t serves row t >> 3, chunk
  t & 7: chunks 0-3 copy the signature's 16-byte words, 4-6 the
  patch's 8-byte words, 7 the s_ok flag, the three ints and the active
  flag. Every source and destination chunk is aligned to its size
  given the packed buffer's and the buffers' base alignment; a row
  whose pos is out of range writes nothing;
- k_clear: thread t writes lanes [16 t, 16 t + 16) (fewer at the
  end), lane i active iff i % per == 0 (per = n for K6, a shard's lanes
  for K8): one division a thread for the first shard start in its
  lanes, the next ones every per lanes after it.

The model writes every byte of every spliced row exactly once and
nothing else. The wrappers' alignment check, which each arena runs
once when it is built, fires on a misaligned base. Tolerance: exact."""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.tpu import resident as jresident
from tendermint_tpu_torch.crypto.cuda import kernels, resident
from tendermint_tpu_torch.device import set_default_device

PARTS = 8  # TM_SPLICE_PARTS
N = 1088   # lanes of the spliced buffers


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


def _buffers(n: int) -> dict:
    return dict(sb=np.zeros((n, 64), np.uint8), s_ok=np.zeros(n, bool),
                patch=np.zeros((n, 24), np.uint8),
                split=np.zeros(n, np.int32), patch_len=np.zeros(n, np.int32),
                group=np.zeros(n, np.int32), active=np.zeros(n, bool))


def splice_model(packed: np.ndarray, n: int, bufs: dict) -> dict:
    """k_splice's threads over `packed` into the numpy buffers `bufs`
    (bytes views, in place); returns each buffer's per-byte write
    counts. Asserts every chunk's alignment (packed base 16-aligned, sb
    16-, patch 8-aligned)."""
    k = packed.size // resident.ROW_BYTES
    ints = packed[:16 * k].view(np.int32)
    raw = {name: b.reshape(-1).view(np.uint8) for name, b in bufs.items()}
    writes = {name: np.zeros(r.size, np.int64) for name, r in raw.items()}

    def put(name, off, data):
        raw[name][off:off + len(data)] = data
        writes[name][off:off + len(data)] += 1

    for t in range(k * PARTS):
        row, part = t >> 3, t & 7
        pos = int(ints[row])
        if pos < 0 or pos >= n:
            continue
        if part < 4:
            src, dst = 16 * k + 64 * row + 16 * part, 64 * pos + 16 * part
            assert src % 16 == 0 and dst % 16 == 0
            put("sb", dst, packed[src:src + 16])
        elif part < 7:
            c = part - 4
            src, dst = 80 * k + 24 * row + 8 * c, 24 * pos + 8 * c
            assert src % 8 == 0 and dst % 8 == 0
            put("patch", dst, packed[src:src + 8])
        else:
            put("s_ok", pos, [packed[104 * k + row] != 0])
            for j, name in enumerate(("split", "patch_len", "group")):
                put(name, 4 * pos, ints[(j + 1) * k + row:(j + 1) * k + row + 1]
                    .view(np.uint8))
            put("active", pos, [1])
    return writes


def _rows(rng, k: int, n: int):
    """k delta rows at distinct slots (one row a slot, as the arena
    packs them) with random contents."""
    pos = rng.choice(np.arange(1, n), size=k, replace=False)
    sig = rng.integers(0, 256, (k, 64), dtype=np.uint8)
    patch = rng.integers(0, 256, (k, 24), dtype=np.uint8)
    s_ok = rng.random(k) < 0.7
    ints = rng.integers(-2**31, 2**31, (3, k)).astype(np.int32)
    return pos, sig, s_ok, patch, ints


def _reference_splice(bufs: dict, pos, sig, s_ok, patch, ints) -> dict:
    """The JAX package's _splice_fn on copies of `bufs`."""
    import jax.numpy as jnp

    names = ("sb", "s_ok", "patch", "split", "patch_len", "group", "active")
    out = jresident._splice_fn()(
        *(jnp.asarray(bufs[k].copy()) for k in names),
        jnp.asarray(np.asarray(pos, np.int32)), jnp.asarray(sig),
        jnp.asarray(s_ok), jnp.asarray(patch), *map(jnp.asarray, ints))
    return {k: np.asarray(v) for k, v in zip(names, out)}


@pytest.mark.parametrize("k", [1, 3, 1024])
def test_splice_map_writes_each_row_once(k):
    """For k rows the model writes each spliced row's 64 + 24 + 1 + 12 +
    1 bytes once and no other byte; its buffers equal splice_plain's and
    the reference _splice_fn's."""
    rng = np.random.default_rng(k)
    pos, sig, s_ok, patch, ints = _rows(rng, k, N)
    packed = resident.pack_delta(pos, sig, s_ok, patch, *ints)
    start = _buffers(N)
    start["sb"][:] = rng.integers(0, 256, start["sb"].shape)
    model = {name: b.copy() for name, b in start.items()}
    writes = splice_model(packed, N, model)
    per_lane = {"sb": 64, "patch": 24, "s_ok": 1, "split": 4,
                "patch_len": 4, "group": 4, "active": 1}
    for name, count in writes.items():
        want = np.zeros((N, per_lane[name]), np.int64)
        want[pos] = 1
        assert np.array_equal(count, want.reshape(-1)), name
    plain = {name: torch.from_numpy(b.copy()) for name, b in start.items()}
    resident.splice_plain(*(plain[k_] for k_ in (
        "sb", "s_ok", "patch", "split", "patch_len", "group", "active")),
        torch.from_numpy(packed))
    ref = _reference_splice(start, pos, sig, s_ok, patch, ints)
    for name in start:
        assert np.array_equal(model[name], plain[name].numpy()), name
        assert np.array_equal(model[name], ref[name]), name


def test_splice_map_drops_an_out_of_range_row():
    """A row whose pos is past the buffers writes nothing: the model's
    buffers equal the reference's _splice_fn (which drops it too) and
    splice_plain's of the other rows."""
    rng = np.random.default_rng(5)
    pos, sig, s_ok, patch, ints = _rows(rng, 3, N)
    pos[1] = N
    packed = resident.pack_delta(pos, sig, s_ok, patch, *ints)
    start = _buffers(N)
    model = {name: b.copy() for name, b in start.items()}
    writes = splice_model(packed, N, model)
    assert sum(int(w.sum()) for w in writes.values()) == 2 * (64 + 24 + 14)
    ref = _reference_splice(start, pos, sig, s_ok, patch, ints)
    keep = [0, 2]
    plain = {name: torch.from_numpy(b.copy()) for name, b in start.items()}
    resident.splice_plain(*(plain[k_] for k_ in (
        "sb", "s_ok", "patch", "split", "patch_len", "group", "active")),
        torch.from_numpy(resident.pack_delta(
            pos[keep], sig[keep], s_ok[keep], patch[keep],
            *(a[keep] for a in ints))))
    for name in start:
        assert np.array_equal(model[name], ref[name]), name
        assert np.array_equal(model[name], plain[name].numpy()), name


def clear_model(active: np.ndarray, per: int) -> np.ndarray:
    """k_clear's threads: thread t writes lanes [16 t, 16 t + 16) (fewer
    at the end), setting those from the first shard start at or after
    16 t on, every per lanes; returns the write counts."""
    n = active.size
    writes = np.zeros(n, np.int64)
    for t in range(-(-n // 16)):
        lo = 16 * t
        r = lo % per
        starts = set(range(lo if r == 0 else lo + per - r, lo + 16, per))
        for i in range(lo, min(lo + 16, n)):
            active[i] = i in starts
            writes[i] += 1
    return writes


@pytest.mark.parametrize("n,per", [(12288, 12288), (16384, 4096),
                                   (4 * 130, 130), (1000, 1000)])
def test_clear_map_equals_plain_and_reference(n, per):
    """per = n: K6's clear, against clear_plain and _clear_fn; per = a
    shard's lanes: K8's, against mesh_clear_plain and _mesh_clear_fn (the
    (n / per, per) view). Every lane written once; the wrappers on CPU
    tensors agree."""
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    start = rng.random(n) < 0.5
    model = start.copy()
    assert np.array_equal(clear_model(model, per), np.ones(n, np.int64))
    got = torch.from_numpy(start.copy())
    if per == n:
        resident.clear_plain(got)
        ref = np.asarray(jresident._clear_fn()(jnp.asarray(start.copy())))
        wrapped = torch.from_numpy(start.copy())
        resident.clear(wrapped)
    else:
        resident.mesh_clear_plain(got.view(-1, per))
        ref = np.asarray(jresident._mesh_clear_fn()(
            jnp.asarray(start.reshape(-1, per).copy()))).reshape(-1)
        wrapped = torch.from_numpy(start.copy())
        resident.mesh_clear(wrapped, per)
    assert np.array_equal(model, got.numpy())
    assert np.array_equal(model, ref)
    assert np.array_equal(model, wrapped.numpy())


def test_alignment_check_fires_on_a_misaligned_base():
    """check_splice_buffers (run once by each arena's splicer when it is
    built, and by the wrappers at every call) takes 16-byte-aligned sb
    and active and an 8-byte-aligned patch, and refuses a base off by a
    byte; an arena's own buffers pass."""
    n = 64

    def bufs(shift: dict):
        def base(name, shape, dtype):
            count = int(np.prod(shape)) * torch.tensor([], dtype=dtype).element_size()
            raw = torch.zeros(count + 16, dtype=torch.uint8)
            off = shift.get(name, 0)
            return raw[off:off + count].view(dtype).view(shape)
        return (base("sb", (n, 64), torch.uint8), base("s_ok", (n,), torch.bool),
                base("patch", (n, 24), torch.uint8),
                *(base(nm, (n,), torch.int32) for nm in
                  ("split", "patch_len", "group")),
                base("active", (n,), torch.bool))

    resident.check_splice_buffers(*bufs({}))
    for name in ("sb", "patch", "active"):
        with pytest.raises(kernels.KernelError, match="aligned"):
            resident._Splicer(bufs({name: 1}), mesh=False)
    resident.check_splice_buffers(*bufs({"patch": 8}))
    arena = resident.ResidentArena(100)
    resident.check_splice_buffers(*arena.buffers())
