#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name and power limit (nvidia-smi);
2. build — the CUDA kernels built from tendermint_tpu_torch/csrc;
3. kernels — each of K1, K3 and K4 against its plain PyTorch version on
   an adversarial batch (1,024 lanes over 256 keys), K3's structured
   form (K2's assembly inside the launch) on a structured commit with
   one lane's patch off by a byte against assemble_plain + xverify_plain
   and against the bytes form on the host's own sign bytes, K6/K7 on a
   1,024-lane speculation arena holding the adversarial lanes and some
   inactive ones, and K9 on a 1,024-lane sr25519 adversarial batch
   (verdicts also equal to sr25519_ref.verify on every lane, and every
   branch of the ristretto equality and square root taken): verdicts
   bit-identical, tables, sign bytes and the seven spliced buffers
   identical; K4's, K7's and K9's verdict digests equal to
   VERDICT_DIGESTS;
4. slice — a 10,240-validator set and a signed 10,240-signature commit
   through ValidatorSet.verify_commit, verify_commit_light and
   verify_commit_light_trusting (trust 1/3), a corrupted signature that
   must be named, and a 64-lane BatchVerifier; the launch counters are
   zeroed just before and read just after, and every kernel of the
   path (K1, K3 with K2 inside, K4) must have launched;
5. speculation — the same set and commit through the SpeculationPlane:
   begin_height, the precommits observed in 10 bursts of 1,024 with a
   flush_sync after each (one K6 splice and one K7 launch each, the
   sentinel lane holding), then serve_commit, which must serve a full
   hit with no verification launch; then a commit with one corrupted
   signature, which must be rejected at its index after re-verifying
   that lane alone. Counters zeroed before and read after; K6 (splice,
   clear) and K7 must have launched;
6. mixed — a 10,240-validator set whose odd-numbered keys are sr25519
   (signed with the bulk signer sr_sign_batch) and even-numbered ones
   ed25519, and its signed commit through verify_commit (5 runs, p50,
   and the stages of one run), verify_commit_light and
   verify_commit_light_trusting: each call must launch K9 once for the
   sr25519 lanes and K4 once for the ed25519 lanes, and K1, K3 and K7
   never; a corrupted sr25519 and a corrupted ed25519 signature
   must each be named; one duplicate-vote evidence check on an sr25519
   validator (valid, then with a bad signature);
7. fabric — the multi-device verify fabric on a mesh: every CUDA
   device when there are at least two, else four logical shards of
   cuda:0 (four table blocks, four lane sets, four launches on four
   streams). K5 against its plain version, shard by shard, on the
   adversarial batch (256 keys split over the shards) in both forms:
   the message rows routed (bytes) and assembled in the kernel from the
   templates (structured). Then, with the crossover at 5,120 keys, the
   slice phase's set and commit: the sharded table build (one K1 launch
   a key range), verify_commit (11 runs, p50), _light and _trusting,
   each launching K5 once per shard and K3 never with the slice
   phase's outcome, the corrupted signature rejected at the same index;
   the mixed phase's commit through verify_commit, each call launching
   K4 and K9 once per shard with the mixed phase's outcomes and
   rejections. Counters zeroed before, read after. Then, outside that
   run, the sharded verdicts lane for lane against the one-card set's;
8. healing — the self-healing fabric on the fabric phase's mesh, with
   the port's clock advanced past each cooldown: K8 (the per-shard
   arena: K6's splice and K7's verify once per device over its block
   of shards, and tm_mesh_clear) against its plain versions on a
   1,024-lane adversarial arena through the (D, per, ...) view; then,
   counters zeroed before and read after, the speculation phase's
   commit through a SpeculationPlane on a MeshResidentArena (10 bursts
   of 1,024, one K6 and one K7 launch a device a flush, counted as
   K8's mesh_splice and mesh_arena_verify, a full hit,
   the per-shard upload bound), a lying shard (its sentinel signature
   flipped on the card: only its entry evicted, one host recheck, the
   commit still served), live reshards of the arena and of the cached
   sharded set 4 -> 3 (K5 three times a call, the slice phase's
   outcomes and rejection, verdicts equal to the one-card set's lane
   for lane), the device.shard_fail failpoint evicting a second entry
   (-> 2), re-admission by half-open probes (-> 4), the backend
   breaker under a 64-lane BatchVerifier and the degraded sr25519
   route; the fallback counters must move by exactly what was
   injected. The comparisons in that run (one-card verdicts, the
   timed probe, the on-device K4 and K9 references) have their
   launches taken back out of the counts;
9. timing — each kernel at the main path's shapes: its device time a
   call (`ms`: back-to-back calls captured in a CUDA graph and the
   replay timed by CUDA events, no host gaps) and its wrapper's time a
   call (`wrapper_us`: CUDA events around as many calls made from
   Python, the host's work between launches included), the plain version's time, its bound, and its agreement
   with the plain version (K2's row: what its assembly adds to the
   structured K3 launch that carries it, against the bytes form on the
   same lanes) on those inputs (K4 at the 64-lane BatchVerifier's
   128-lane bucket and, as general_verify_mixed, at the mixed
   commit's 8,192-lane bucket; K9 at its 5,120 lanes); for the kernels
   that spread a key or a lane over many threads (K1, K3, K4, K5, K7,
   K8's verify, K9, in both fields) the launch shapes (grid, block,
   dynamic shared memory, resident warps an SM from
   cudaOccupancyMaxActiveBlocksPerMultiprocessor, registers and stack)
   and the ptxas spills: each launch must run at least 4 threads a key
   or lane, with no spills;
10. fault — in a child (`--phase fault`; a sticky fault poisons the
   context): a test-only kernel built from FAULT_SOURCE, never part of
   the port's library, stores through a bad address just before K4
   inside a BatchVerifier; the ladder must raise KernelError with a
   kernel-fault code (700), every breaker closed, no counter moved;
11. f32 — in a child with TM_TPU_FIELD=f32 (`--phase f32 --i32
   <digests>`; the field is chosen at import): the f32 library built
   (every source with -DTM_FIELD_F32); the kernels check again, K1,
   K3, K4, K5, K7 and K9 against their f32 plain versions, their
   verdicts against the digests of the i32 build's (kernels and fabric
   phases) that the parent passes; the slice and mixed phases again at
   10,240 validators, with the i32 phases' launches, outcomes and
   rejections; the f32 p50s and kernel times beside the i32 ones, and
   the f32 kernels' rows (`<name>_f32`) in the kernels line, K7 also
   at the speculation arena's 12,288 lanes (arena_verify_spec_f32).

Each child's lines are relayed as {"phase": <child>, "step": ...}; a
child that fails or outruns its time limit fails the run. Every phase
but healing must end with all breakers closed and the host fallbacks,
rechecks and evictions unchanged. Then the kernels line, the
nvidia-smi line and, last, {"ok": true, "device": {...}}. Any failure
raises (exit code 1); no phase is caught. Without a CUDA device it
exits 2 and prints no result; with TM_TPU_FIELD set to anything but
i32 it refuses to run (its f32 phase sets the variable for its child).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types

N_VALIDATORS = 10_240
CHAIN = "smoke-chain"
# The field this process's kernels use (crypto/cuda/fieldsel.py reads
# the same variable): i32 here, f32 in the f32 phase's child.
FIELD = os.environ.get("TM_TPU_FIELD", "i32")
# H100 SXM published peaks (NVIDIA H100 datasheet for HBM3 bandwidth;
# Hopper white paper for the int32 rate, 132 SMs x 64 INT32 lanes x 1.98
# GHz, and the FP32 FMA rate, 132 SMs x 128 FP32 lanes x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_FMA_PER_S = 132 * 128 * 1.98e9
# The operation bound counts the products of the field multiplies the
# function needs: in the i32 field int32 x int32 -> int64 products in
# radix 2^25.5 (ten limbs), 100 for a multiply, 55 for a squaring (as
# the kernels' fe_sqr forms them), against the int32 rate; in the f32 field FP32 FMAs over 32 limbs, 1,024 for a multiply,
# 528 for a squaring, against the FMA rate. Point ops use the
# reference's formulas; SHA-512, the fold, additions and carries are not
# counted, so the bound is a floor.
MUL, SQR, NLIMB, OPS_PER_S = {
    "f32": (1024, 528, 32, FP32_FMA_PER_S)}.get(
        FIELD, (100, 55, 10, INT32_OPS_PER_S))
ADD = 9 * MUL                     # add-2008-hwcd-3 (ge_add)
ADD_Z1 = 8 * MUL                  # Z2 = 1: the comb add (ge_add_z1)
DOUBLE = 4 * SQR + 4 * MUL        # dbl-2008-hwcd (ge_double)
DECOMPRESS = 255 * SQR + 19 * MUL  # + MUL where x * sqrt(-1) is taken
# ristretto decode: 257 squarings (pow_2_252_m3's 251 and six more) and
# 24 multiplies (those by the constant u = 1 not counted), + MUL where
# the root is multiplied by sqrt(-1)
RS_DECODE = 257 * SQR + 24 * MUL
RS_EQUAL = 4 * MUL
ENTRY_BYTES = 4 * NLIMB * 4       # one table entry: X, Y, Z, T, 4-byte limbs

SPEC_BURST = 1024                 # precommits per flush_sync
# bytes a splice writes per row: sb, s_ok, patch, split, patch_len,
# group, active (it reads the packed row, resident.ROW_BYTES)
SPLICE_WRITE = 64 + 1 + 24 + 3 * 4 + 1

REPLACES = {
    "build_tables": "tendermint_tpu/crypto/tpu/expanded.py:128",
    "assemble": "tendermint_tpu/crypto/tpu/expanded.py:318",
    "xverify": "tendermint_tpu/crypto/tpu/expanded.py:186",
    "general_verify": "tendermint_tpu/crypto/tpu/verify.py:173",
    "splice": "tendermint_tpu/crypto/tpu/resident.py:65",
    "clear": "tendermint_tpu/crypto/tpu/resident.py:87",
    "arena_verify": "tendermint_tpu/crypto/tpu/resident.py:162",
    "arena_verify_spec": "tendermint_tpu/crypto/tpu/resident.py:162",
    "sr_verify": "tendermint_tpu/crypto/tpu/sr_verify.py:51",
    "general_verify_mixed": "tendermint_tpu/crypto/tpu/verify.py:173",
    "shard_verify": "tendermint_tpu/crypto/tpu/expanded.py:394",
    "mesh_splice": "tendermint_tpu/crypto/tpu/resident.py:99",
    "mesh_clear": "tendermint_tpu/crypto/tpu/resident.py:126",
    "mesh_arena_verify": "tendermint_tpu/crypto/tpu/resident.py:138",
}
SOURCES = {
    "build_tables": "tendermint_tpu_torch/csrc/build_tables.cu",
    "assemble": "tendermint_tpu_torch/csrc/xverify.cu",
    "xverify": "tendermint_tpu_torch/csrc/xverify.cu",
    "general_verify": "tendermint_tpu_torch/csrc/general_verify.cu",
    "splice": "tendermint_tpu_torch/csrc/splice.cu",
    "clear": "tendermint_tpu_torch/csrc/splice.cu",
    "arena_verify": "tendermint_tpu_torch/csrc/arena_verify.cu",
    "arena_verify_spec": "tendermint_tpu_torch/csrc/arena_verify.cu",
    "sr_verify": "tendermint_tpu_torch/csrc/sr_verify.cu",
    "general_verify_mixed": "tendermint_tpu_torch/csrc/general_verify.cu",
    "shard_verify": "tendermint_tpu_torch/csrc/xverify.cu",
    "mesh_splice": "tendermint_tpu_torch/csrc/splice.cu",
    "mesh_clear": "tendermint_tpu_torch/csrc/splice.cu",
    "mesh_arena_verify": "tendermint_tpu_torch/csrc/arena_verify.cu",
}
# The __global__ function of each row (K5 is K3's kernel, and K2 runs
# inside it; K8's splice, clear and verify are K6's and K7's kernels;
# K1 is two launches, the chain's and the rows'; the
# general_verify_mixed row is K4 at the mixed commit's shape).
GLOBALS = {name: "k_" + name for name in SOURCES}
GLOBALS.update(assemble="k_xverify", shard_verify="k_xverify",
               mesh_splice="k_splice", mesh_clear="k_clear",
               mesh_arena_verify="k_arena_verify",
               arena_verify_spec="k_arena_verify",
               build_tables=("k_build_chain", "k_build_rows"),
               general_verify_mixed="k_general_verify")
# The kernel whose launches a row counts, where it is not the row's own
# (the arena_verify_spec row is K7 at the speculation arena's shape in
# the f32 child, which runs no speculation plane).
ROW_KERNEL = {"general_verify_mixed": "general_verify",
              "arena_verify_spec": "arena_verify"}
# K2 is no launch of its own: it runs inside the structured form of K3
# and K5 (csrc/xverify.cu), as the reference traces assemble_core into
# _skernel; its row counts the launches that carry it.
INSIDE = {"assemble": ("xverify", "shard_verify")}
# The kernels spread over many threads a key or lane (K1, K3, K4, K5,
# K7, K8's verify, K9): the shape export of each and its number of
# launches (kernels.launch_shapes). Each launch must run at least
# MIN_THREADS_PER_ITEM threads a key or lane, with no spills.
SHAPE_EXPORTS = {"build_tables": ("tm_build_tables_shape", 2),
                 "xverify": ("tm_xverify_shape", 1),
                 "shard_verify": ("tm_xverify_shape", 1),
                 "general_verify": ("tm_general_verify_shape", 1),
                 "sr_verify": ("tm_sr_verify_shape", 1),
                 "arena_verify": ("tm_arena_verify_shape", 1),
                 "mesh_arena_verify": ("tm_arena_verify_shape", 1)}
# K4's, K7's and K9's verdict digests on the kernels check's adversarial
# batches and arena, as the one-thread-a-lane kernels gave them in both
# fields: the four-thread-a-lane bodies must reproduce them.
VERDICT_DIGESTS = {"general_verify": "a106af0ce1da1c4b",
                   "arena_verify": "424457bc6352ff63",
                   "sr_verify": "f73a94992d6667f6"}
MIN_THREADS_PER_ITEM = 4
SLICE_KERNELS = ("build_tables", "xverify", "general_verify")
SPEC_KERNELS = ("splice", "clear", "arena_verify")
MIXED_KERNELS = ("general_verify", "sr_verify")
# The fabric phase's logical mesh when the machine has one card, and
# the crossover that splits the 10,240-key set into 4 x 2,560 keys.
LOGICAL_SHARDS = 4
FABRIC_CROSSOVER = 5120
FABRIC_RUNS = 11  # verify_commit runs on the mesh; the first is dropped
# Objects a later step of the same process reads: the kernels check's
# arena (the f32 phase times K7 on it).
KEEP: dict = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def wrappers():
    from tendermint_tpu_torch.crypto.cuda import (expanded, resident,
                                                  sr_verify, verify)

    return {"build_tables": expanded.build_tables,
            "xverify": expanded.xverify,
            "general_verify": verify.general_verify,
            "splice": resident.splice,
            "clear": resident.clear,
            "arena_verify": resident.arena_verify,
            "sr_verify": sr_verify.sr_verify,
            "shard_verify": expanded.shard_verify,
            "mesh_splice": resident.mesh_splice,
            "mesh_clear": resident.mesh_clear,
            "mesh_arena_verify": resident.mesh_arena_verify}


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events around `reps`
    back-to-back calls, after one warm-up: the host's work between the
    launches (a wrapper's checks, allocations, ctypes call) is inside
    it wherever it leaves the card idle."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, replays: int = 3) -> float:
    """Mean device milliseconds of a call of fn, with no host gaps: after
    one warm-up call, `reps` calls captured in one CUDA graph, and the
    graph replayed `replays` times between two CUDA events, so the
    calls' launches and copies run back to back on the card as the
    graph's nodes. The wrappers' Python runs once, at the capture."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    return ms


def kernel_times(fn, reps: int) -> dict:
    """A row's two times for fn: `ms`, its device time a call
    (device_ms: a CUDA graph's replay), and `wrapper_us`, a call through
    its Python wrapper in microseconds by CUDA events (cuda_ms), host
    gaps included."""
    return {"ms": device_ms(fn, reps), "wrapper_us": cuda_ms(fn, reps) * 1e3}


def ptxas_summary(log: str, fn: str) -> dict:
    """The lines of an `nvcc -Xptxas -v` report for the __global__
    function `fn` (a source may hold several): its registers, stack
    frame and spills. Its mangled name holds len(fn) then fn."""
    tag = f"{len(fn)}{fn}"
    lines = [ln.strip() for ln in log.splitlines()]
    out, inside = {}, False
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln:
            inside = tag in ln
        if not inside:
            continue
        if "Function properties for" in ln and tag in ln and i + 1 < len(lines):
            out["frame"] = lines[i + 1]
        if ln.startswith("ptxas info") and "Used" in ln and "registers" in ln:
            out["registers"] = ln.split(":", 1)[1].strip()
    return out


def kernel_ptxas(name: str) -> dict:
    """ptxas_summary of the kernels line's row `name` (of each of its
    __global__ functions, by name, where it has several)."""
    from tendermint_tpu_torch.crypto.cuda import kernels

    log = kernels.BUILD_INFO.get("ptxas", {}).get(
        SOURCES[name].rsplit("/", 1)[1], "")
    fns = GLOBALS[name]
    if isinstance(fns, tuple):
        return {fn: ptxas_summary(log, fn) for fn in fns}
    return ptxas_summary(log, fns)


def spill_bytes(summary: dict) -> int:
    """Spill stores plus loads in a kernel_ptxas report."""
    subs = (list(summary.values()) if summary and all(
        isinstance(v, dict) for v in summary.values()) else [summary])
    return sum(int(x) for sub in subs
               for x in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                   sub.get("frame", "")))


def launch_info(name: str, n: int, *form) -> dict:
    """How a redesigned kernel (SHAPE_EXPORTS) launches for n keys or
    lanes on this card: each launch's grid, block, dynamic shared bytes,
    resident warps an SM, registers and stack (the runtime's), the
    threads a key or lane, and the ptxas spills. Fails unless every
    launch runs at least MIN_THREADS_PER_ITEM threads a key or lane and
    nothing spills."""
    from tendermint_tpu_torch.crypto.cuda import kernels

    export, count = SHAPE_EXPORTS[ROW_KERNEL.get(name, name)]
    shapes = kernels.launch_shapes(export, n, *form, launches=count)
    for s in shapes:
        s["threads_per_item"] = s["blocks"] * s["threads"] / n
    ptxas = kernel_ptxas(name)
    out = {"served": n, "launches": shapes, "ptxas": ptxas,
           "spill_bytes": spill_bytes(ptxas)}
    if (min(s["threads_per_item"] for s in shapes) < MIN_THREADS_PER_ITEM
            or out["spill_bytes"] or not ptxas):
        raise AssertionError(f"{name} launch shape: {out}")
    return out


def max_abs_diff(a, b) -> int:
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def sqrt_m1_branches(rows) -> int:
    """How many of the (n, 32) uint8 encodings take ZIP-215
    decompression's x * sqrt(-1) branch (v x^2 == -u): one multiply
    more each."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    p, n = ref.P, 0
    for enc in rows.cpu().numpy():
        y = int.from_bytes(enc.tobytes(), "little") & ((1 << 255) - 1)
        u = (y * y - 1) % p
        v = (ref.D * y * y + 1) % p
        x = u * pow(v, 3, p) * pow(u * pow(v, 7, p), (p - 5) // 8, p) % p
        n += (v * x * x + u) % p == 0
    return n


def lane_digits(ab, sb, msg, nblocks):
    """The 69 nibbles of each lane's folded challenge k' and the 69 of
    its S, LSB-first, by the port's plain functions: two (69, N)."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import scalar as sc
    from tendermint_tpu_torch.crypto.cuda import sha512 as sh

    full = torch.cat([sb[:, :32], ab, msg], dim=1)
    digest = sh.compress_blocks(sh.bytes_to_words(full), nblocks)
    k = sc.fold_digest(sh.digest_bytes_le(digest)).flip(0)
    s = sc.bytes_to_nibbles(sb[:, 32:].to(torch.int64).T)
    return k, torch.cat([s, torch.zeros_like(s[:5])])


def adds_after_first(digits) -> int:
    """Point adds an accumulator needs for these (69, N) digits: one
    per nonzero digit, less the first, which only copies."""
    return int(((digits != 0).sum(0) - 1).clamp(min=0).sum().item())


# -- phase 3 -------------------------------------------------------------


def structured_commit(n_lanes: int, seed: int):
    """A commit whose slots mix for-block and nil votes and edge
    timestamps, signed by fresh keys: the shape K2 assembles."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.types.block import (
        BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader)

    seeds = [hashlib.sha256(b"sc-%d-%d" % (seed, i)).digest()
             for i in range(n_lanes)]
    pubs = [ref.public_key_from_seed(s) for s in seeds]
    bid = BlockID(bytes(range(32)), PartSetHeader(3, bytes(32)))
    edge = [0, 1, 999_999_999, 1_000_000_000, 1_753_928_000_123_456_789]
    sigs = [CommitSig(BlockIDFlag.NIL if i % 7 == 3 else BlockIDFlag.COMMIT,
                      bytes([i % 256]) * 20, edge[i % len(edge)] + i, b"")
            for i in range(n_lanes)]
    commit = Commit(977, 1, bid, sigs)
    for i, cs in enumerate(sigs):
        cs.signature = ref.sign(seeds[i], commit.vote_sign_bytes(CHAIN, i))
    return pubs, commit


def kernel_phase(n_keys: int, n_lanes: int, dev) -> dict:
    """Each kernel against its plain version on adversarial inputs."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto import vectors
    from tendermint_tpu_torch.crypto.cuda import expanded, verify
    from tendermint_tpu_torch.crypto.cuda.fieldsel import F as fe
    from tendermint_tpu_torch.types.sign_batch import CommitSignBatch

    out = {}
    before = {k: fn.launches for k, fn in wrappers().items()}
    b = vectors.adversarial_batch(n_keys, n_lanes, seed=1)
    expect = b["expect"]
    # K1: tables limb for limb (same arithmetic), and mod p.
    akeys = torch.from_numpy(
        np.frombuffer(b"".join(b["pubkeys"]), np.uint8).reshape(-1, 32).copy()
    ).to(dev)
    tab_k, ok_k = expanded.build_tables(akeys)
    tab_p, ok_p = expanded.build_tables_plain(akeys)
    canon_k = fe.canonical(tab_k.reshape(-1, fe.NLIMB).T.to(fe.DTYPE))
    canon_eq = bool(torch.equal(
        canon_k, fe.canonical(tab_p.reshape(-1, fe.NLIMB).T.to(fe.DTYPE))))
    out["build_tables"] = dict(
        limbs_equal=bool(torch.equal(tab_k, tab_p)), canonical_equal=canon_eq,
        ok_equal=bool(torch.equal(ok_k, ok_p)),
        key_ok_0_1=ok_k.cpu().tolist()[:2])
    # what the other field's build must reproduce: the key flags, and the
    # canonical values of the first 8 keys' tables
    first = fe.from_limbs(canon_k[:, :8 * 69 * 9 * 4])
    digests = {"build_tables": digest(ok_k), "build_tables_canonical": digest(
        b"".join(v.to_bytes(32, "little") for v in first))}
    if not (out["build_tables"]["limbs_equal"] and canon_eq
            and out["build_tables"]["ok_equal"]):
        raise AssertionError(f"K1 differs from its plain version: {out}")
    if ok_k.cpu().tolist()[:2] != [False, True]:
        raise AssertionError("K1 key_ok: undecodable / small-order keys")
    exp = expanded.ExpandedKeys(b["pubkeys"], device=dev)
    # K3 through the bytes path, against the plain version and expect.
    idx, packed, wf = exp._prepare(b["idx"], b["msgs"], b["sigs"])
    t = verify.to_device(dict(packed, idx=idx), dev)
    args = (t["idx"], exp.akeys, t["sb"], t["s_ok"], exp.key_ok, exp.tables,
            verify._btab(dev))
    bform = dict(msg=t["msg"], nblocks=t["nblocks"])
    v_k = expanded.xverify(*args, **bform)
    v_p = expanded.shard_verify_plain(*args, **bform)
    got = v_k.cpu().numpy()[:n_lanes] & wf
    out["xverify"] = dict(equal_plain=bool(torch.equal(v_k, v_p)),
                          equal_expect=bool((got == expect).all()))
    digests["xverify"] = digest(v_k)
    # K4 on the same lanes with per-lane keys.
    pubs = [b["pubkeys"][k] for k in b["idx"]]
    g = verify.verify_batch(pubs, b["msgs"], b["sigs"], device=dev)
    keep = [i for i, s in enumerate(b["sigs"]) if len(s) == 64]
    bucket = verify._chunks(len(keep))[0]
    dp, dm, ds = verify._dummy_triple()
    pad = bucket - len(keep)
    pk = verify.to_device(verify.pack_batch(
        [pubs[i] for i in keep] + [dp] * pad,
        [b["msgs"][i] for i in keep] + [dm] * pad,
        [b["sigs"][i] for i in keep] + [ds] * pad), dev)
    gargs = (pk["ab"], pk["sb"], pk["msg"], pk["nblocks"], pk["s_ok"],
             verify._btab(dev))
    g_k = verify.general_verify(*gargs)
    out["general_verify"] = dict(
        equal_plain=bool(torch.equal(g_k, verify.general_verify_plain(*gargs))),
        equal_expect=bool((g == expect).all()))
    digests["general_verify"] = digest(g_k)
    # K2 inside K3's structured form, on a structured commit with one
    # lane's patch off by one byte: the verdicts against the plain
    # version (assemble_plain, then xverify_plain) and against the bytes
    # form on the host's own padding of the materialized sign bytes,
    # which assemble_plain must reproduce byte for byte.
    spubs, commit = structured_commit(n_lanes, seed=2)
    sexp = expanded.ExpandedKeys(spubs, device=dev)
    lanes = list(range(n_lanes))
    sbatch = CommitSignBatch(CHAIN, commit, lanes)
    sigs = [cs.signature for cs in commit.signatures]
    sidx, fields, _wf, width = sexp._prepare_structured(lanes, sbatch, sigs)
    off = n_lanes // 3  # the lane whose patch (its length prefix) is off
    patch = fields["patch"].copy()
    patch[off, 0] ^= 1
    f = verify.to_device(dict(fields, patch=patch, idx=sidx), dev)
    sargs = (f["idx"], sexp.akeys, f["sb"], f["s_ok"], sexp.key_ok,
             sexp.tables, verify._btab(dev))
    sform = dict(templates=(f["pre"], f["pre_len"], f["suf"], f["suf_len"]),
                 patches=(f["patch"], f["split"], f["patch_len"], f["group"]),
                 width=width)
    v_s = expanded.xverify(*sargs, **sform)
    m_p, nb_p = expanded.assemble_plain(*sform["templates"], *sform["patches"],
                                        width)
    host = verify.pack_sig_msg(fields["sb"][:n_lanes], sbatch.materialize())
    hw = host["msg"].shape[1]
    m_host = m_p.cpu().numpy()[:n_lanes]
    want = np.ones(n_lanes, bool)
    want[off] = False
    out["assemble"] = dict(
        equal_plain=bool(torch.equal(
            v_s, expanded.shard_verify_plain(*sargs, **sform))),
        equal_bytes_form=bool(torch.equal(
            v_s, expanded.xverify(*sargs, msg=m_p, nblocks=nb_p))),
        plain_equal_host=bool(
            (np.delete(m_host, off, 0)[:, :hw]
             == np.delete(host["msg"], off, 0)).all()
            and (m_host[:, hw:] == 0).all()
            and (nb_p.cpu().numpy()[:n_lanes] == host["nblocks"]).all()),
        verdicts_expected=bool((v_s.cpu().numpy()[:n_lanes] == want).all()))
    digests["xverify_structured"] = digest(v_s)
    sv = sexp.verify_structured(lanes, sbatch, sigs)
    out["assemble"]["commit_verifies"] = bool(sv.all())
    timed = arena_check(n_lanes, dev, out, digests)
    timed.update(sr_check(n_lanes, dev, out, digests))
    for name in ("build_tables", "xverify", "general_verify", "assemble",
                 "splice", "clear", "arena_verify", "sr_verify"):
        if not all(out[name].values()):
            raise AssertionError(f"{name} check failed: {out[name]}")
    for name, fn in wrappers().items():
        if name in out:  # K5 is held in the fabric phase
            out[name]["launches"] = fn.launches - before[name]
    if dev.type == "cuda":  # device and wrapper times at these shapes
        out["build_tables"].update(kernel_times(
            lambda: expanded.build_tables(akeys), 3))
        out["xverify"].update(kernel_times(
            lambda: expanded.xverify(*args, **bform), 5))
        out["general_verify"].update(kernel_times(
            lambda: verify.general_verify(*gargs), 5))
        # K2 has no launch: the structured K3 that carries it
        out["assemble"]["in_xverify"] = kernel_times(
            lambda: expanded.xverify(*sargs, **sform), 5)
        for name, (fn, reps) in timed.items():
            out[name].update(kernel_times(fn, reps))
    moved = {k: digests[k] for k, v in VERDICT_DIGESTS.items()
             if digests[k] != v}
    if moved:
        raise AssertionError(f"verdict digests moved: {moved}, expected "
                             f"{VERDICT_DIGESTS}")
    out["verdicts"] = digests
    return out


def digest(x) -> str:
    """A short digest of a tensor's bytes (or of bytes), to hold one
    field's build against the other's across processes."""
    if not isinstance(x, bytes):
        x = x.cpu().numpy().tobytes()
    return hashlib.sha256(x).hexdigest()[:16]


def splice_args(arena, b, keep):
    """The splice arguments of batch b's lanes `keep` (slot = lane + 1)
    against the arena's group-1 template."""
    import numpy as np

    from tendermint_tpu_torch.types import sign_batch as sbm

    ts = np.asarray([b["ts"][i] for i in keep], np.int64)
    group = np.ones(len(keep), np.int32)
    patch, split, patch_len = sbm._build_patches(
        arena.pre_len.astype(np.int64), arena.suf_len, group, ts)
    sig_rows = np.frombuffer(b"".join(b["sigs"][i] for i in keep),
                             np.uint8).reshape(-1, 64)
    return [i + 1 for i in keep], sig_rows, patch, split, patch_len, group


def arena_check(n_lanes: int, dev, out: dict, digests: dict):
    """K6 and K7 against their plain versions on an n_lanes arena: the
    adversarial lanes with 64-byte signatures are spliced (every 50th
    left out), so the arena also holds inactive lanes. Fills out's
    splice/clear/arena_verify entries and K7's verdict digest; returns
    the calls to time (and the arena, under "arena")."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto import vectors
    from tendermint_tpu_torch.crypto.cuda import resident

    b = vectors.arena_batch(256, n_lanes - 1, seed=4)
    arena = resident.ResidentArena(n_lanes, device=dev)
    arena.install_keys([b["pubkeys"][k] for k in b["idx"]])
    arena.set_template(1, b["pre"], b["suf"])
    keep = [i for i, sig in enumerate(b["sigs"])
            if len(sig) == 64 and i % 50 != 7]
    args = splice_args(arena, b, keep)
    packed = torch.from_numpy(arena.pack(*args)).to(dev)
    ptrs = [t.data_ptr() for t in arena.buffers()]
    plain = [t.clone() for t in arena.buffers()]
    arena.splice(*args)
    resident.splice_plain(*plain, packed)
    out["splice"] = dict(
        equal_plain=all(torch.equal(x, y)
                        for x, y in zip(arena.buffers(), plain)),
        in_place=ptrs == [t.data_ptr() for t in arena.buffers()])
    largs = arena.launch_args()
    v_k = resident.arena_verify(*largs)
    v_p = resident.arena_verify_plain(*largs)
    want = np.zeros(arena.capacity, bool)
    want[0] = True
    for i in keep:
        want[i + 1] = b["expect"][i]
    out["arena_verify"] = dict(
        equal_plain=bool(torch.equal(v_k, v_p)),
        equal_expect=bool((v_k.cpu().numpy() == want).all()),
        active_lanes=arena.active_lanes)
    digests["arena_verify"] = digest(v_k)
    act_k, act_p = arena._active.clone(), arena._active.clone()
    resident.clear(act_k)
    resident.clear_plain(act_p)
    out["clear"] = dict(equal_plain=bool(torch.equal(act_k, act_p)),
                        sentinel_only=int(act_k.sum().item()) == 1)
    timed = {"splice": (lambda: resident.splice(*arena.buffers(), packed), 50),
             "clear": (lambda: resident.clear(act_k), 50),
             "arena_verify": (lambda: resident.arena_verify(*largs), 5)}
    KEEP["arena"] = arena
    return timed


def k4_args(vs, commit, lanes, dev):
    """K4's device arguments for these validators' lanes of the commit,
    packed as the entry points pack them: one bucket, padded with the
    dummy triple."""
    from tendermint_tpu_torch.crypto.cuda import verify

    size = verify._chunks(len(lanes))[0]
    dp, dm, ds = verify._dummy_triple()
    pad = size - len(lanes)
    pk = verify.to_device(verify.pack_batch(
        [vs.validators[i].pub_key.bytes() for i in lanes] + [dp] * pad,
        [commit.vote_sign_bytes(CHAIN, i) for i in lanes] + [dm] * pad,
        [commit.signatures[i].signature for i in lanes] + [ds] * pad), dev)
    return (pk["ab"], pk["sb"], pk["msg"], pk["nblocks"], pk["s_ok"],
            verify._btab(dev))


def sr_args(pubs, msgs, sigs, dev):
    """K9's device arguments for these lanes, and the well-formed mask."""
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv
    from tendermint_tpu_torch.crypto.cuda import verify

    packed, wf = sv.pack_batch_sr(pubs, msgs, sigs)
    t = verify.to_device(packed, dev)
    return (t["ab"], t["rb"], t["kdig"], t["sdig"], t["a_pre"], t["r_pre"],
            t["s_ok"], sv.comb_table(dev)), wf


def sr_branches(args) -> dict:
    """How many lanes take each branch of ristretto equality (V against
    R, on lanes that decode and pass the byte checks) and how many
    decodes of A and R (of encodings that pass the byte checks) take
    each test of sqrt_ratio_m1, by the plain functions."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import ristretto as rs
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv

    ab, rb, kdig, sdig, a_pre, r_pre, s_ok, btab = args
    v, r, a_ok, r_ok = sv.sr_points_plain(ab, rb, kdig, sdig, a_pre, r_pre,
                                          btab)
    xy, yy = rs.equal_branches(v, r)
    live = a_ok & r_ok & s_ok
    pre = torch.cat([a_pre, r_pre])
    c, f, fi = rs.decode_ratio_branches(sv.encoding_limbs(ab, rb))
    count = lambda m: int(m.sum().item())  # noqa: E731
    return {"equal_xy": count(xy & live), "equal_yy": count(yy & live),
            "ratio_correct": count(c & pre), "ratio_flipped": count(f & pre),
            "ratio_flipped_i": count(fi & pre)}


def sr_check(n_lanes: int, dev, out: dict, digests: dict):
    """K9 against its plain version and the oracle on an n_lanes sr25519
    adversarial batch; every branch must be taken. Fills out's
    sr_verify entry and its verdict digest; returns the call to time."""
    import torch

    from tendermint_tpu_torch.crypto import sr25519_ref as sr
    from tendermint_tpu_torch.crypto import vectors
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv

    b = vectors.sr_adversarial_batch(n_lanes, seed=5)
    args, wf = sr_args(b["pubs"], b["msgs"], b["sigs"], dev)
    v_k = sv.sr_verify(*args)
    v_p = sv.sr_verify_plain(*args)
    got = v_k.cpu().numpy() & wf
    oracle = [sr.verify(p, m, s) for p, m, s in zip(b["pubs"], b["msgs"],
                                                     b["sigs"])]
    branches = sr_branches(args)
    out["sr_verify"] = dict(equal_plain=bool(torch.equal(v_k, v_p)),
                            equal_oracle=got.tolist() == oracle,
                            equal_expect=bool((got == b["expect"]).all()),
                            every_branch=min(branches.values()) > 0)
    out["sr_branches"] = branches
    digests["sr_verify"] = digest(v_k)
    return {"sr_verify": (lambda: sv.sr_verify(*args), 5)}


# -- phase 4 -------------------------------------------------------------


def make_commit(n: int):
    """n validators of equal power and a commit signed by all of them
    (bench.py's shape: one block id, per-slot timestamps), and each
    key's seed."""
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.types.block import (
        BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader)
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    seeds = [hashlib.sha256(b"smoke-val-%d" % i).digest() for i in range(n)]
    pubs = [ref.public_key_from_seed(s) for s in seeds]
    vs = ValidatorSet([Validator.new(ed25519.Ed25519PubKey(p), 10)
                       for p in pubs])
    seed_of = {p: s for p, s in zip(pubs, seeds)}
    bid = BlockID(b"\xab" * 32, PartSetHeader(4, b"\xcd" * 32))
    base_ts = 1_753_928_000_000_000_000
    cs = [CommitSig(BlockIDFlag.COMMIT, v.address, base_ts + i * 1_000_003, b"")
          for i, v in enumerate(vs.validators)]
    commit = Commit(123456, 0, bid, cs)
    for i, v in enumerate(vs.validators):
        pub = v.pub_key.bytes()
        cs[i].signature = ref.sign(seed_of[pub],
                                   commit.vote_sign_bytes(CHAIN, i))
    return vs, commit, bid, seed_of


def slice_phase(vs, commit, bid) -> dict:
    import numpy as np

    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto.batch import BatchVerifier
    from tendermint_tpu_torch.types.validator_set import VerificationError

    h = commit.height
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    warm = vs.warm_device_tables()
    if warm is None:
        raise AssertionError("the set does not take the expanded path")
    warm.join()  # re-raises a failed build
    table_build_s = time.perf_counter() - t0
    if kernels["build_tables"].launches != 1:
        raise AssertionError("the table build did not launch K1 once: "
                             f"{kernels['build_tables'].launches}")
    runs = []
    for _ in range(11):
        t0 = time.perf_counter()
        vs.verify_commit(CHAIN, bid, h, commit)
        runs.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    vs.verify_commit_light(CHAIN, bid, h, commit)
    light_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    vs.verify_commit_light_trusting(CHAIN, commit, 1, 3)
    trusting_ms = (time.perf_counter() - t0) * 1e3
    bad = len(vs.validators) * 27 // 64
    good_sig = commit.signatures[bad].signature
    commit.signatures[bad].signature = good_sig[:40] + bytes(
        [good_sig[40] ^ 4]) + good_sig[41:]
    try:
        vs.verify_commit(CHAIN, bid, h, commit)
    except VerificationError as e:
        message = str(e)
    else:
        raise AssertionError("corrupted commit verified")
    finally:
        commit.signatures[bad].signature = good_sig
    if message != f"invalid signature(s) at index(es) [{bad}]":
        raise AssertionError(f"wrong rejection: {message}")
    # 64 lanes (40 <= n < 128): BatchVerifier's general kernel.
    bv = BatchVerifier()
    for i in range(64):
        v = vs.validators[i]
        sig = commit.signatures[i].signature
        if i == 7:
            sig = sig[:33] + bytes([sig[33] ^ 1]) + sig[34:]
        bv.add(v.pub_key, commit.vote_sign_bytes(CHAIN, i), sig)
    all_ok, lanes = bv.verify()
    want = np.ones(64, bool)
    want[7] = False
    if all_ok or not (lanes == want).all():
        raise AssertionError("BatchVerifier verdicts")
    launches = {name: kernels[name].launches for name in SLICE_KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"a kernel did not launch: {launches}")
    breakdown = commit_breakdown(vs, commit)
    # the repo's oracle on a few lanes of the same commit
    for i in (0, bad, len(vs.validators) - 1):
        v = vs.validators[i]
        if not ref.verify(v.pub_key.bytes(), commit.vote_sign_bytes(CHAIN, i),
                          commit.signatures[i].signature):
            raise AssertionError(f"oracle rejects lane {i}")
    return dict(table_build_s=table_build_s,
                verify_commit_ms=runs[1:],
                verify_commit_p50_ms=statistics.median(runs[1:]),
                first_verify_commit_ms=runs[0],
                verify_commit_light_ms=light_ms,
                verify_commit_light_trusting_ms=trusting_ms,
                rejected=message, launches=launches, breakdown=breakdown)


def commit_breakdown(vs, commit, reps: int = 7) -> dict:
    """Median ms of the stages of one structured verify_commit at this
    size: the host's CommitSignBatch and packing, then the device call
    (uploads, K3 with K2 inside, verdict readback). Its launches are counted
    outside the main-path run (the caller has read the counters)."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import expanded
    from tendermint_tpu_torch.types.sign_batch import CommitSignBatch

    exp = expanded.get_expanded([v.pub_key.bytes() for v in vs.validators])
    lanes = list(range(len(vs.validators)))
    sigs = [cs.signature for cs in commit.signatures]
    stages = {"sign_batch": [], "prepare": [], "device": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        sb = CommitSignBatch(CHAIN, commit, lanes)
        t1 = time.perf_counter()
        prepared = exp._prepare_structured(lanes, sb, sigs)
        t2 = time.perf_counter()
        exp._launch_structured(prepared[0], prepared[1], prepared[3]).cpu()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[k].append(dt * 1e3)
    return {k + "_ms": statistics.median(v) for k, v in stages.items()}


# -- phase 5 -------------------------------------------------------------


def speculation_phase(vs, commit, bid):
    """The verify-ahead path at full width: precommits observed in
    bursts and flushed (K6 + K7 each), a commit served from the
    speculated verdicts with no verification launch, and a corrupted
    commit rejected after re-verifying its one bad lane. Returns the
    phase's record and the plane's arena."""
    import torch

    from tendermint_tpu_torch.config import SpeculationConfig
    from tendermint_tpu_torch.consensus import SpeculationPlane
    from tendermint_tpu_torch.crypto.cuda.resident import ResidentArena
    from tendermint_tpu_torch.types.validator_set import VerificationError
    from tendermint_tpu_torch.types.vote import Vote, VoteType

    h, r = commit.height, commit.round
    votes = [Vote(VoteType.PRECOMMIT, h, r, bid, cs.timestamp,
                  cs.validator_address, i, cs.signature)
             for i, cs in enumerate(commit.signatures)]
    kernels = wrappers()
    host_ms: dict[str, list] = {"splice": [], "launch": []}

    def timed(name, fn):
        def run(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(self, *a, **kw)
            torch.cuda.synchronize()
            host_ms[name].append((time.perf_counter() - t0) * 1e3)
            return res
        return run

    orig = ResidentArena.splice, ResidentArena.launch
    ResidentArena.splice = timed("splice", orig[0])
    ResidentArena.launch = timed("launch", orig[1])
    try:
        for fn in kernels.values():
            fn.launches = 0
        plane = SpeculationPlane(SpeculationConfig())
        plane.begin_height(CHAIN, vs, h, r, bid)
        flushes = []
        for start in range(0, len(votes), SPEC_BURST):
            for v in votes[start:start + SPEC_BURST]:
                plane.observe_precommit(v)
            k6, k7 = kernels["splice"].launches, kernels["arena_verify"].launches
            t0 = time.perf_counter()
            plane.flush_sync()  # raises if the sentinel lane fails
            flush_ms = (time.perf_counter() - t0) * 1e3
            if (kernels["splice"].launches - k6,
                    kernels["arena_verify"].launches - k7) != (1, 1):
                raise AssertionError("a flush did not launch K6 and K7 once")
            flushes.append(dict(active_lanes=plane._arena.active_lanes,
                                splice_ms=host_ms["splice"][-1],
                                launch_ms=host_ms["launch"][-1],
                                flush_ms=flush_ms))
    finally:
        ResidentArena.splice, ResidentArena.launch = orig
    lanes = plane._heights[h].lanes
    if len(lanes) != len(votes) or not all(ln.verdict for ln in lanes.values()):
        raise AssertionError("a speculated lane did not verify")
    verify_kernels = ("xverify", "shard_verify", "general_verify",
                      "arena_verify")
    before = {k: kernels[k].launches for k in verify_kernels}
    t0 = time.perf_counter()
    served = plane.serve_commit(vs, CHAIN, bid, h, commit)
    serve_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    vs.hash()  # serve_commit matches the valset by its hash
    valset_hash_ms = (time.perf_counter() - t0) * 1e3
    during = {k: kernels[k].launches - before[k] for k in verify_kernels}
    if not (served and plane.hits == 1 and not any(plane.misses.values())):
        raise AssertionError(f"no full hit: {plane.hits} {plane.misses}")
    if any(during.values()):
        raise AssertionError(f"a hit launched verification: {during}")
    # one corrupted signature: only its lane may re-verify
    bad = len(votes) * 37 // 64
    good_sig = commit.signatures[bad].signature
    commit.signatures[bad].signature = good_sig[:50] + bytes(
        [good_sig[50] ^ 8]) + good_sig[51:]
    called = []

    def spy(lanes_, msgs, sigs, _orig=vs._batch_verify_lanes):
        called.append(list(lanes_))
        return _orig(lanes_, msgs, sigs)

    vs._batch_verify_lanes = spy
    try:
        plane.serve_commit(vs, CHAIN, bid, h, commit)
    except VerificationError as e:
        message = str(e)
    else:
        raise AssertionError("corrupted commit served")
    finally:
        del vs._batch_verify_lanes
        commit.signatures[bad].signature = good_sig
    if message != f"invalid signature(s) at index(es) [{bad}]" or \
            called != [[bad]] or plane.misses["mismatch"] != 1:
        raise AssertionError(f"wrong rejection: {message} {called}")
    launches = {name: kernels[name].launches for name in SPEC_KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"a kernel did not launch: {launches}")
    lane_verifies = sum(f["active_lanes"] - 1 for f in flushes)
    return dict(flushes=flushes, serve_commit_ms=serve_ms,
                valset_hash_ms=valset_hash_ms, serve_launches=during,
                rejected=message, lane_verifies=lane_verifies,
                launches=launches,
                arena_bytes=plane._arena.arena_bytes(),
                reupload_bytes=plane._arena.reupload_bytes), plane._arena


# -- phase 6 -------------------------------------------------------------


def make_mixed_commit(n: int):
    """n validators of equal power, key i sr25519 when i is odd and
    ed25519 when even (the set sorts them by address), and a commit
    signed by all of them: one block id, per-slot timestamps."""
    from tendermint_tpu_torch.crypto import ed25519, sr25519, vectors
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto import sr25519_ref as sr
    from tendermint_tpu_torch.types.block import (
        BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader)
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    vals, secret_of = [], {}
    for i in range(n):
        if i % 2:
            secret = hashlib.sha256(b"smoke-sr-%d" % i).digest()
            pk = sr25519.Sr25519PubKey(sr.public_key_from_mini(secret))
        else:
            secret = hashlib.sha256(b"smoke-val-%d" % i).digest()
            pk = ed25519.Ed25519PubKey(ref.public_key_from_seed(secret))
        vals.append(Validator.new(pk, 10))
        secret_of[pk.bytes()] = secret
    vs = ValidatorSet(vals)
    bid = BlockID(b"\xab" * 32, PartSetHeader(4, b"\xcd" * 32))
    base_ts = 1_753_928_000_000_000_000
    cs = [CommitSig(BlockIDFlag.COMMIT, v.address, base_ts + i * 1_000_003, b"")
          for i, v in enumerate(vs.validators)]
    commit = Commit(123457, 0, bid, cs)
    sr_slots = []
    for i, v in enumerate(vs.validators):
        if v.pub_key.type_name == "sr25519":
            sr_slots.append(i)
        else:
            cs[i].signature = ref.sign(secret_of[v.pub_key.bytes()],
                                       commit.vote_sign_bytes(CHAIN, i))
    sigs = vectors.sr_sign_batch(
        [secret_of[vs.validators[i].pub_key.bytes()] for i in sr_slots],
        [commit.vote_sign_bytes(CHAIN, i) for i in sr_slots])
    for i, sig in zip(sr_slots, sigs):
        cs[i].signature = sig
    return vs, commit, bid, secret_of


def mixed_phase(vs, commit, bid, secret_of, dev) -> dict:
    """The mixed set's commit through the three entry points, launch
    counts read around each call, two corrupted commits and the
    duplicate-vote check."""
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv
    from tendermint_tpu_torch.crypto.cuda import verify
    from tendermint_tpu_torch.types.validator_set import VerificationError

    h = commit.height
    n_sr = sum(v.pub_key.type_name == "sr25519" for v in vs.validators)
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    if vs.warm_device_tables() is not None:
        raise AssertionError("a mixed set took the expanded path")
    groups = []
    real = verify.verify_batch, sv.verify_batch_sr

    def spy(name, fn):
        return lambda *a, **k: groups.append((name, len(a[0]))) or fn(*a, **k)

    def call(fn, *args) -> float:
        before = {k: f.launches for k, f in kernels.items()}
        groups.clear()
        t0 = time.perf_counter()
        fn(*args)
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: f.launches - before[k] for k, f in kernels.items()}
        want = {k: int(k in MIXED_KERNELS) for k in kernels}
        if delta != want:
            raise AssertionError(f"{fn.__name__} launched {delta}")
        return ms

    verify.verify_batch = spy("ed25519", real[0])
    sv.verify_batch_sr = spy("sr25519", real[1])
    try:
        runs = [call(vs.verify_commit, CHAIN, bid, h, commit)
                for _ in range(5)]
        if sorted(groups) != [("ed25519", len(vs) - n_sr), ("sr25519", n_sr)]:
            raise AssertionError(f"verify_commit's groups: {groups}")
        light_ms = call(vs.verify_commit_light, CHAIN, bid, h, commit)
        light_groups = list(groups)
        trusting_ms = call(vs.verify_commit_light_trusting, CHAIN, commit,
                           1, 3)
        trusting_groups = list(groups)
        rejected = {}
        for kind in ("sr25519", "ed25519"):
            bad = next(i for i in range(len(vs) * 27 // 64, len(vs))
                       if vs.validators[i].pub_key.type_name == kind)
            good = commit.signatures[bad].signature
            commit.signatures[bad].signature = good[:40] + bytes(
                [good[40] ^ 4]) + good[41:]
            try:
                call(vs.verify_commit, CHAIN, bid, h, commit)
            except VerificationError as e:
                rejected[kind] = str(e)
            else:
                raise AssertionError(f"corrupted {kind} commit verified")
            finally:
                commit.signatures[bad].signature = good
            if rejected[kind] != f"invalid signature(s) at index(es) [{bad}]":
                raise AssertionError(f"wrong rejection: {rejected[kind]}")
    finally:
        verify.verify_batch, sv.verify_batch_sr = real
    launches = {name: kernels[name].launches for name in MIXED_KERNELS}
    evidence = duplicate_vote_check(vs, secret_of)
    return dict(sr25519_lanes=n_sr, ed25519_lanes=len(vs) - n_sr,
                verify_commit_ms=runs,
                verify_commit_p50_ms=statistics.median(runs),
                verify_commit_light_ms=light_ms,
                light_groups=light_groups,
                verify_commit_light_trusting_ms=trusting_ms,
                trusting_groups=trusting_groups, rejected=rejected,
                evidence=evidence, launches=launches,
                breakdown=mixed_breakdown(vs, commit, dev))


def duplicate_vote_check(vs, secret_of) -> dict:
    """verify_duplicate_vote on an sr25519 validator's two precommits for
    two block ids: accepted, then rejected with one signature broken."""
    from tendermint_tpu_torch.crypto import sr25519_ref as sr
    from tendermint_tpu_torch.evidence.verify import (EvidenceError,
                                                      verify_duplicate_vote)
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
    from tendermint_tpu_torch.types.vote import Vote, VoteType

    slot = next(i for i, v in enumerate(vs.validators)
                if v.pub_key.type_name == "sr25519")
    val = vs.validators[slot]
    votes = []
    for b in (0x61, 0x62):
        bid = BlockID(bytes([b]) * 32, PartSetHeader(1, bytes([b]) * 32))
        v = Vote(VoteType.PRECOMMIT, 99, 0, bid, 1_753_928_000_000_000_000,
                 val.address, slot)
        v.signature = sr.sign(secret_of[val.pub_key.bytes()],
                              v.sign_bytes(CHAIN))
        votes.append(v)
    ev = DuplicateVoteEvidence.from_votes(votes[0], votes[1], 1_753_928_000,
                                          vs)
    ev.validate_basic()
    t0 = time.perf_counter()
    verify_duplicate_vote(ev, CHAIN, vs, 1_753_928_000)
    ms = (time.perf_counter() - t0) * 1e3
    good = ev.vote_b.signature
    ev.vote_b.signature = good[:9] + bytes([good[9] ^ 1]) + good[10:]
    try:
        verify_duplicate_vote(ev, CHAIN, vs, 1_753_928_000)
    except EvidenceError as e:
        message = str(e)
    else:
        raise AssertionError("duplicate vote with a bad signature verified")
    if message != "invalid signature on vote B":
        raise AssertionError(f"wrong evidence error: {message}")
    return dict(validator_index=slot, verify_ms=ms, rejected=message)


def mixed_breakdown(vs, commit, dev) -> dict:
    """Milliseconds of the stages of one mixed verify_commit, as its
    code runs them: the slot loop and sign bytes, grouping by key type,
    ed25519 packing and upload, K4 (CUDA events), the Merlin challenges,
    sr25519 packing and upload, K9 (CUDA events), and the readback of
    both verdicts. Its launches are outside the main-path run (the
    caller has read the counters)."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv
    from tendermint_tpu_torch.crypto.cuda import verify

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    t = [time.perf_counter()]
    lanes, sigs = [], []
    for idx, cs in enumerate(commit.signatures):
        if not cs.is_absent():
            lanes.append(idx)
            sigs.append(cs.signature)
    msgs = vs._commit_msgs(CHAIN, commit, lanes, lanes)
    t.append(time.perf_counter())
    by_type: dict[str, list[int]] = {}
    for j, i in enumerate(lanes):
        by_type.setdefault(vs.validators[i].pub_key.type_name, []).append(j)
    ed_j, sr_j = by_type["ed25519"], by_type["sr25519"]
    t.append(time.perf_counter())
    size = verify._chunks(len(ed_j))[0]
    dp, dm, ds = verify._dummy_triple()
    pad = size - len(ed_j)
    pk = verify.to_device(verify.pack_batch(
        [vs.validators[lanes[j]].pub_key.bytes() for j in ed_j] + [dp] * pad,
        [msgs[j] for j in ed_j] + [dm] * pad,
        [sigs[j] for j in ed_j] + [ds] * pad), dev)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    ev[0].record()
    v_ed = verify.general_verify(pk["ab"], pk["sb"], pk["msg"], pk["nblocks"],
                                 pk["s_ok"], verify._btab(dev))
    ev[1].record()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    c = sv.check_bytes([vs.validators[lanes[j]].pub_key.bytes() for j in sr_j],
                       [sigs[j] for j in sr_j])
    t.append(time.perf_counter())
    ks = sv.sr25519_challenges(c["ab"], [msgs[j] for j in sr_j], c["rb"])
    t.append(time.perf_counter())
    st = verify.to_device(dict(
        ab=c["ab"], rb=c["rb"], kdig=sv._nibbles(ks, len(sr_j)),
        sdig=sv._nibbles_of_bytes(c["s_raw"]), a_pre=c["a_pre"],
        r_pre=c["r_pre"], s_ok=c["s_ok"]), dev)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    ev[2].record()
    v_sr = sv.sr_verify(st["ab"], st["rb"], st["kdig"], st["sdig"],
                        st["a_pre"], st["r_pre"], st["s_ok"],
                        sv.comb_table(dev))
    ev[3].record()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    ok = bool(v_ed.cpu().numpy()[:len(ed_j)].all()) and bool(
        v_sr.cpu().numpy().all())
    t.append(time.perf_counter())
    if not ok:
        raise AssertionError("the breakdown's verdicts reject the commit")
    ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    return {"slot_loop_sign_bytes_ms": ms[0], "grouping_ms": ms[1],
            "ed25519_pack_upload_ms": ms[2],
            "k4_launch_sync_ms": ms[3],
            "k4_events_ms": ev[0].elapsed_time(ev[1]),
            "k4_lanes": size,
            "sr25519_byte_checks_ms": ms[4], "merlin_ms": ms[5],
            "sr25519_nibbles_upload_ms": ms[6],
            "k9_launch_sync_ms": ms[7],
            "k9_events_ms": ev[2].elapsed_time(ev[3]),
            "readback_ms": ms[8]}


def sr_work(args) -> tuple[int, int]:
    """K9's work on lanes whose byte checks pass (the others' verdicts
    are already false): (int32 products, bytes)."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import ristretto as rs
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv

    ab, rb, kdig, sdig, a_pre, r_pre, s_ok, btab = args
    live = a_pre & r_pre & s_ok
    m = int(live.sum().item())
    c, f, fi = rs.decode_ratio_branches(sv.encoding_limbs(ab[live], rb[live]))
    kd, sd = kdig[:, live], sdig[:, live]
    top = torch.where(kd != 0, torch.arange(64, device=ab.device)[:, None],
                      0).max(0).values  # doublings start after it
    # per lane: decode A and R, the 16-entry table of -A (14 adds), 4
    # doublings per window below k's top nonzero nibble, an add per
    # nonzero nibble of k and of s, the final add, the equality
    ops = (2 * m * RS_DECODE + int((f | fi).sum().item()) * MUL
           + m * 14 * ADD + int(top.sum().item()) * 4 * DOUBLE
           + adds_after_first(kd) * ADD + adds_after_first(sd) * ADD_Z1
           + m * (ADD + RS_EQUAL))
    # A, R, the two nibble rows, three flags and the verdict per lane,
    # and the comb
    nbytes = ab.shape[0] * (32 + 32 + 64 + 64 + 3 + 1) + btab.numel() * 4
    return ops, nbytes


def sr_row(vs, commit, dev) -> dict:
    """K9 at the mixed commit's sr25519 lanes: time, plain time, bound
    and agreement with the plain version."""
    lanes = [i for i, v in enumerate(vs.validators)
             if v.pub_key.type_name == "sr25519"]
    args, _ = sr_args([vs.validators[i].pub_key.bytes() for i in lanes],
                      [commit.vote_sign_bytes(CHAIN, i) for i in lanes],
                      [commit.signatures[i].signature for i in lanes], dev)
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv

    v_k = sv.sr_verify(*args)
    v_p, p_ms = plain_ms(lambda: sv.sr_verify_plain(*args))
    if not bool(v_k.all()):
        raise AssertionError("K9 rejects the valid commit's lanes")
    ops, nbytes = sr_work(args)
    row = entry("sr_verify", max_abs_diff(v_k, v_p),
                kernel_times(lambda: sv.sr_verify(*args), 10), p_ms, ops,
                nbytes)
    row["lanes"] = len(lanes)
    row["launch"] = launch_info("sr_verify", len(lanes))
    return row


def k4_mixed_row(vs, commit, dev) -> dict:
    """K4 at the mixed commit's ed25519 lanes (one 8,192-lane bucket)."""
    lanes = [i for i, v in enumerate(vs.validators)
             if v.pub_key.type_name == "ed25519"]
    return k4_row("general_verify_mixed", k4_args(vs, commit, lanes, dev),
                  len(lanes))


def k4_row(name, gargs, live: int) -> dict:
    """K4 on gargs, whose first `live` lanes are a valid commit's: time,
    plain time, bound, launch shape and agreement with the plain
    version."""
    from tendermint_tpu_torch.crypto.cuda import verify

    ab, sb, msg, nblocks, s_ok, btab = gargs
    v_k = verify.general_verify(*gargs)
    v_p, p_ms = plain_ms(lambda: verify.general_verify_plain(*gargs))
    if not bool(v_k[:live].all()):
        raise AssertionError("K4 rejects the valid commit's lanes")
    ops, nbytes = general_work(ab, sb, msg, nblocks, s_ok.bool())
    row = entry(name, max_abs_diff(v_k, v_p),
                kernel_times(lambda: verify.general_verify(*gargs), 10), p_ms,
                ops, nbytes + btab.numel() * 4)
    row["lanes"], row["live_lanes"] = int(ab.shape[0]), live
    row["launch"] = launch_info(name, row["lanes"])
    return row


# -- phase 7 -------------------------------------------------------------


def fabric_mesh() -> tuple[list[str], str]:
    """Every CUDA device when there are at least two, else
    LOGICAL_SHARDS logical shards of cuda:0."""
    import torch

    n = torch.cuda.device_count()
    if n >= 2:
        return [f"cuda:{i}" for i in range(n)], "physical"
    return ["cuda:0"] * LOGICAL_SHARDS, "logical"


def k5_check(dev) -> dict:
    """K5 against its plain version, shard by shard, on the adversarial
    batch as precommits (256 keys split over the mesh) in both forms,
    and the routed verdicts against the expected ones."""
    import torch

    from tendermint_tpu_torch.crypto import vectors
    from tendermint_tpu_torch.crypto.cuda import expanded, verify

    b = vectors.arena_batch(256, 1024, seed=6)
    expanded.set_shard_crossover(128)
    try:
        exp = expanded.ExpandedKeys(b["pubkeys"])
    finally:
        expanded.set_shard_crossover(FABRIC_CROSSOVER)
    if not exp.sharded:
        raise AssertionError("the adversarial set did not shard")
    idx, packed, wf = exp._prepare(b["idx"], b["msgs"], b["sigs"])
    sidx, fields, swf, width = exp._prepare_structured(
        b["idx"], vectors.LaneSignBatch(b), b["sigs"])
    tpl = verify.to_device({k: fields[k] for k in exp._S_REPL}, dev)
    forms = {"bytes": (idx, packed, {}, wf),
             "structured": (sidx, {k: v for k, v in fields.items()
                                   if k not in exp._S_REPL},
                            dict(templates=tuple(tpl[k] for k in exp._S_REPL),
                                 width=width), swf)}
    out = {"shards": exp.n_shards, "keys_per_shard": exp.keys_per_shard,
           "verdicts": {}}
    for name, (fidx, lanes, form, well_formed) in forms.items():
        lidx, routed, slot = exp._route(fidx, lanes)
        err, got = 0, []
        for d, shard_dev in enumerate(exp.mesh):
            with torch.cuda.device(shard_dev):
                args, kw = exp._k5_args(d, shard_dev, lidx, routed, **form)
                k = expanded.shard_verify(*args, **kw)
                err = max(err, max_abs_diff(
                    k, expanded.shard_verify_plain(*args, **kw)))
            got.append(k.to(dev))
            if d == 0 and name == "bytes":
                KEEP["k5_shard0"] = (args, kw)
        verdicts = torch.cat(got).cpu().numpy()[slot] & well_formed
        out["verdicts"][f"shard_verify_{name}"] = digest(verdicts.tobytes())
        out[name] = dict(max_abs_err=err, n_local=int(lidx.shape[1]),
                         equal_expect=bool((verdicts == b["expect"]).all()))
        if err or not out[name]["equal_expect"]:
            raise AssertionError(f"K5 check ({name}) failed: {out[name]}")
    return out


def k5_check_row() -> dict:
    """K5 on shard 0 of k5_check's bytes form (the adversarial batch):
    time, plain time, bound and agreement with the plain version."""
    from tendermint_tpu_torch.crypto.cuda import expanded

    args, kw = KEEP["k5_shard0"]
    v_k = expanded.shard_verify(*args, **kw)
    v_p, p_ms = plain_ms(lambda: expanded.shard_verify_plain(*args, **kw))
    s_idx, akeys, sb, s_ok, key_ok, _tables, btab = args
    ops, lane_bytes, msg_bytes, m = xverify_work(
        akeys, key_ok, s_idx, sb, s_ok, kw["msg"], kw["nblocks"])
    nbytes = lane_bytes + m * 4 + msg_bytes + btab.numel() * 4
    row = entry("shard_verify", max_abs_diff(v_k, v_p),
                kernel_times(lambda: expanded.shard_verify(*args, **kw), 10),
                p_ms,
                ops, nbytes)
    row["lanes"] = int(s_idx.shape[0])
    row["launch"] = launch_info("shard_verify", row["lanes"], 0)
    return row


def fabric_phase(vs, commit, bid, mvs, mcommit, mbid, rejected_mixed,
                 dev):
    """The fabric on a mesh (fabric_mesh): K5's check, then the sharded
    ed25519 commit and the mixed commit through the entry points with
    the counters zeroed before and read after, then, outside that run,
    the sharded verdicts against the one-card set's, the per-shard lane
    counts and K5's time per shard launch. Returns the phase's record
    and K5's kernels row."""
    from tendermint_tpu_torch.crypto.cuda import expanded
    from tendermint_tpu_torch.device import set_mesh

    pubkeys = [v.pub_key.bytes() for v in vs.validators]
    single = expanded.get_expanded(pubkeys)  # the slice phase's set
    if single.mesh is not None:
        raise AssertionError("the one-card set was built on a mesh")
    mesh, kind = fabric_mesh()
    set_mesh(mesh)
    expanded.set_shard_crossover(FABRIC_CROSSOVER)
    try:
        return _fabric(vs, commit, bid, mvs, mcommit, mbid, rejected_mixed,
                       single, mesh, kind, dev)
    finally:
        expanded.set_shard_crossover(None)
        set_mesh(None)


def _fabric(vs, commit, bid, mvs, mcommit, mbid, rejected_mixed, single,
            mesh, kind, dev):
    import numpy as np

    from tendermint_tpu_torch.crypto.cuda import expanded
    from tendermint_tpu_torch.types.sign_batch import CommitSignBatch
    from tendermint_tpu_torch.types.validator_set import VerificationError

    d_n = len(mesh)
    out = {"mesh": mesh, "mesh_kind": kind, "k5_check": k5_check(dev)}
    kernels = wrappers()

    def call(fn, *args, want: dict):
        """fn(*args): host ms and the VerificationError text, if any;
        its launches must be `want`."""
        before = {k: f.launches for k, f in kernels.items()}
        message = None
        t0 = time.perf_counter()
        try:
            fn(*args)
        except VerificationError as e:
            message = str(e)
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: f.launches - before[k] for k, f in kernels.items()}
        if delta != {k: want.get(k, 0) for k in kernels}:
            raise AssertionError(f"{fn.__name__} launched {delta}")
        return ms, message

    # the main path: counters zeroed just before, read just after
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    warm = vs.warm_device_tables()
    if warm is None:
        raise AssertionError("the set does not take the expanded path")
    warm.join()
    build_s = time.perf_counter() - t0
    exp = expanded.get_expanded([v.pub_key.bytes() for v in vs.validators])
    if not (exp.sharded and exp.n_shards == d_n
            and kernels["build_tables"].launches == d_n):
        raise AssertionError(f"sharded build: {exp.sharded} {exp.n_shards} "
                             f"{kernels['build_tables'].launches}")
    h = commit.height
    k5 = {"shard_verify": d_n}
    runs = [call(vs.verify_commit, CHAIN, bid, h, commit, want=k5)
            for _ in range(FABRIC_RUNS)]
    light = call(vs.verify_commit_light, CHAIN, bid, h, commit, want=k5)
    trusting = call(vs.verify_commit_light_trusting, CHAIN, commit, 1, 3,
                    want=k5)
    if any(m for _, m in runs + [light, trusting]):
        raise AssertionError("the sharded path rejected the valid commit")
    bad = len(vs.validators) * 27 // 64
    good_sig = commit.signatures[bad].signature
    commit.signatures[bad].signature = good_sig[:40] + bytes(
        [good_sig[40] ^ 4]) + good_sig[41:]
    try:
        _, message = call(vs.verify_commit, CHAIN, bid, h, commit, want=k5)
    finally:
        commit.signatures[bad].signature = good_sig
    if message != f"invalid signature(s) at index(es) [{bad}]":
        raise AssertionError(f"wrong rejection: {message}")
    mixed_want = {"general_verify": d_n, "sr_verify": d_n}
    mixed_ms, mixed_msg = call(mvs.verify_commit, CHAIN, mbid, mcommit.height,
                               mcommit, want=mixed_want)
    if mixed_msg is not None:
        raise AssertionError(f"the mesh rejected the mixed commit: {mixed_msg}")
    mixed_rejected = {}
    for key_type, want_msg in rejected_mixed.items():
        i = int(want_msg.split("[")[1].rstrip("]"))
        good = mcommit.signatures[i].signature
        mcommit.signatures[i].signature = good[:40] + bytes(
            [good[40] ^ 4]) + good[41:]
        try:
            _, mixed_rejected[key_type] = call(
                mvs.verify_commit, CHAIN, mbid, mcommit.height, mcommit,
                want=mixed_want)
        finally:
            mcommit.signatures[i].signature = good
    if mixed_rejected != rejected_mixed:
        raise AssertionError(f"mixed rejections on the mesh: {mixed_rejected}")
    launches = {k: kernels[k].launches for k in
                ("build_tables", "shard_verify", "general_verify",
                 "sr_verify")}
    # outside the main-path run: the sharded verdicts against the
    # one-card set's, lane for lane, in both forms, on the commit with
    # its corrupted signature
    lanes = list(range(len(vs.validators)))
    commit.signatures[bad].signature = good_sig[:40] + bytes(
        [good_sig[40] ^ 4]) + good_sig[41:]
    try:
        sbatch = CommitSignBatch(CHAIN, commit, lanes)
        sigs = [cs.signature for cs in commit.signatures]
        msgs = sbatch.materialize()
        v_sh = exp.verify_structured(lanes, sbatch, sigs)
        v_one = single.verify_structured(lanes, sbatch, sigs)
        b_sh = exp.verify(lanes, msgs, sigs)
        b_one = single.verify(lanes, msgs, sigs)
    finally:
        commit.signatures[bad].signature = good_sig
    want = np.ones(len(lanes), bool)
    want[bad] = False
    if not ((v_sh == v_one).all() and (b_sh == b_one).all()
            and (v_sh == want).all()):
        raise AssertionError("sharded verdicts differ from the one-card set's")
    trusting_lanes = vs.plan_commit_trusting(CHAIN, commit, 1, 3).lanes
    row, shard_ms = k5_row(exp, commit, lanes, dev)
    out.update(
        build_s=build_s, keys_per_shard=exp.keys_per_shard,
        shard_lanes=shard_lanes(exp, lanes),
        trusting_shard_lanes=shard_lanes(exp, trusting_lanes),
        verify_commit_ms=[ms for ms, _ in runs[1:]],
        verify_commit_p50_ms=statistics.median(ms for ms, _ in runs[1:]),
        first_verify_commit_ms=runs[0][0],
        verify_commit_light_ms=light[0],
        verify_commit_light_trusting_ms=trusting[0], rejected=message,
        verdicts_equal_one_card=True, mixed_verify_commit_ms=mixed_ms,
        mixed_rejected=mixed_rejected, k5_ms=shard_ms,
        device_call_ms=device_call_ms(exp, single, commit, lanes),
        launches=launches)
    return out, row


def shard_lanes(exp, lanes) -> dict:
    """Real lanes per shard and the common bucket n_local of a routed
    launch over these lanes."""
    import numpy as np

    counts = np.bincount(np.asarray(lanes) // exp.keys_per_shard,
                         minlength=exp.n_shards)
    return {"real": counts.tolist(),
            "n_local": exp._bucket(max(int(counts.max()), 1))}


def device_call_ms(exp, single, commit, lanes, reps: int = 5) -> dict:
    """Median host ms of the device call of one structured verify of the
    commit (uploads, launches, verdict readback; and the sharded set's
    routing) on the sharded set and on the one-card set, and of the
    routing alone."""
    import torch

    from tendermint_tpu_torch.types.sign_batch import CommitSignBatch

    sbatch = CommitSignBatch(CHAIN, commit, lanes)
    sigs = [cs.signature for cs in commit.signatures]
    out = {}
    for name, keys in (("sharded", exp), ("one_card", single)):
        idx, fields, _wf, width = keys._prepare_structured(lanes, sbatch, sigs)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            keys._launch_structured(idx, fields, width).cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    idx, fields, _wf, _width = exp._prepare_structured(lanes, sbatch, sigs)
    per = {k: v for k, v in fields.items() if k not in exp._S_REPL}
    times = []
    for _ in range(reps):  # the host routing inside the sharded call
        t0 = time.perf_counter()
        exp._route(idx, per)
        times.append((time.perf_counter() - t0) * 1e3)
    out["sharded_route"] = statistics.median(times)
    return out


def k5_row(exp, commit, lanes, dev):
    """K5 at the main path's shapes: each shard's launch on the valid
    commit's routed lanes timed alone by CUDA events, then all of them
    on their streams; shard 0's against its plain version, with its
    bound and its device time. Returns the kernels row and the
    times."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import expanded, verify
    from tendermint_tpu_torch.types.sign_batch import CommitSignBatch

    sbatch = CommitSignBatch(CHAIN, commit, lanes)
    sigs = [cs.signature for cs in commit.signatures]
    idx, fields, _wf, width = exp._prepare_structured(lanes, sbatch, sigs)
    tpl = verify.to_device({k: fields[k] for k in exp._S_REPL}, dev)
    templates = tuple(tpl[k] for k in exp._S_REPL)
    lidx, routed, _slot = exp._route(idx, {k: v for k, v in fields.items()
                                            if k not in exp._S_REPL})
    shard_ms, calls = [], []
    for d, shard_dev in enumerate(exp.mesh):
        with torch.cuda.device(shard_dev):
            args, kw = exp._k5_args(d, shard_dev, lidx, routed, templates,
                                    width)
            shard_ms.append(cuda_ms(
                lambda: expanded.shard_verify(*args, **kw), 10))
        calls.append((args, kw))
    # all shards' launches as a sharded verify makes them, one stream
    # each: the span from before the first to after the join
    shard_ms.append(cuda_ms(lambda: verify.run_shards(
        exp.mesh, lambda d, _dev: expanded.shard_verify(*calls[d][0],
                                                        **calls[d][1])), 10))
    args, kw = calls[0]
    v_k = expanded.shard_verify(*args, **kw)
    v_p, p_ms = plain_ms(lambda: expanded.shard_verify_plain(*args, **kw))
    msg, nblocks = expanded.assemble_plain(*kw["templates"], *kw["patches"],
                                           width)
    s_idx, akeys, sb, s_ok, key_ok, _tables, btab = args
    ops, lane_bytes, _msg_bytes, m = xverify_work(akeys, key_ok, s_idx, sb,
                                                  s_ok, msg, nblocks)
    # and per lane the patch, split, patch_len and group; the templates;
    # the comb
    nbytes = (lane_bytes + m * (24 + 3 * 4) + btab.numel() * 4
              + sum(t.numel() * t.element_size() for t in kw["templates"]))
    row = entry("shard_verify", max_abs_diff(v_k, v_p), kernel_times(
        lambda: expanded.shard_verify(*args, **kw), 10), p_ms, ops, nbytes)
    row["lanes"] = int(s_idx.shape[0])
    row["launch"] = launch_info("shard_verify", row["lanes"], 1)
    return row, {"per_shard": shard_ms[:-1], "all_shards": shard_ms[-1]}


# -- phase 8 -------------------------------------------------------------


class PhaseClock:
    """The port's clock (libs/clock.py) while the healing phase runs: it
    stands still but where the phase passes the breakers' cooldowns, so
    an evicted entry stays out however long the host takes, and comes
    back exactly when the phase says."""

    def __init__(self):
        self.t = time.monotonic()

    def monotonic(self) -> float:
        return self.t

    def pass_cooldowns(self) -> None:
        from tendermint_tpu_torch.crypto import batch as cbatch

        brs = list(cbatch._BREAKERS.values()) + list(
            cbatch._DEVICE_BREAKERS.values())
        self.t += max(b.cooldown_remaining() for b in brs) + 1.0


def fallback_state() -> dict:
    """The breakers' states and the fallback counters, to compare a
    phase's end with its start."""
    import copy

    from tendermint_tpu_torch.crypto import batch as cbatch

    return {"breakers": cbatch.breaker_states(),
            "device_breakers": cbatch.device_breaker_states(),
            "metrics": copy.deepcopy(cbatch.METRICS)}


def no_fallback(phase: str, before: dict) -> None:
    """A phase other than healing must leave every breaker closed and
    the host fallbacks, rechecks and evictions as they were."""
    after = fallback_state()
    closed = (all(v == "closed" for v in after["breakers"].values())
              and all(v == "closed"
                      for v in after["device_breakers"].values()))
    if not closed or after["metrics"] != before["metrics"]:
        raise AssertionError(f"{phase}: a fallback was taken: {before} -> "
                             f"{after}")


def shard_deltas(arena, slots, sig_rows, patch, split, patch_len, group):
    """The splice's delta rows routed by the round-robin rule on its own
    (slot s -> shard (s-1) % D, local slot (s-1) // D + 1; a slot given
    twice keeps its last row): D packed deltas at local slots, for the
    plain version, and per device block one at block lanes, for K8."""
    import numpy as np

    from tendermint_tpu_torch.crypto.cuda import resident, verify

    d_n, per = arena.n_shards, arena.shard_capacity
    last = {s: j for j, s in enumerate(slots)}
    rows = sorted((s, j) for s, j in last.items())
    by_shard = [[(s, j) for s, j in rows if (s - 1) % d_n == d]
                for d in range(d_n)]

    def pack(pairs, pos):
        j = np.asarray([j for _, j in pairs], np.int64)
        return resident.pack_delta(
            pos, sig_rows[j], verify.s_range_ok(sig_rows[j]), patch[j],
            split[j], patch_len[j], group[j])

    local = [pack(p, [(s - 1) // d_n + 1 for s, _ in p]) for p in by_shard]
    blocks = []
    for blk in arena._blocks:
        pairs, pos = [], []
        for e, d in enumerate(blk["shards"]):
            pairs += by_shard[d]
            pos += [e * per + (s - 1) // d_n + 1 for s, _ in by_shard[d]]
        blocks.append(pack(pairs, pos))
    return local, blocks


def k8_check(dev) -> dict:
    """K8 against its plain versions on a 1,024-lane adversarial arena
    over the mesh: the splice (duplicate slots, inactive lanes) byte for
    byte through the (D, per, ...) view, the verdicts and every shard's
    sentinel exactly, then the clear."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto import vectors
    from tendermint_tpu_torch.crypto.cuda import resident, verify

    b = vectors.arena_batch(256, 1023, seed=7)
    arena = resident.MeshResidentArena(1024)
    arena.install_keys([b["pubkeys"][k] for k in b["idx"]])
    arena.set_template(1, b["pre"], b["suf"])
    keep = [i for i, sig in enumerate(b["sigs"])
            if len(sig) == 64 and i % 50 != 7]
    keep += keep[:40:4]  # slots given twice, with the same rows
    slots, *rows = splice_args(arena, b, keep)
    local, _ = shard_deltas(arena, slots, *rows)
    names = ("sb", "s_ok", "patch", "split", "patch_len", "group", "active")
    plain = [arena.view(n, dev) for n in names]
    arena.splice(slots, *rows)
    resident.mesh_splice_plain(plain, [torch.from_numpy(p).to(dev)
                                       for p in local])
    out = {"shards": arena.n_shards, "per": arena.shard_capacity,
           "blocks": len(arena._blocks)}
    out["mesh_splice"] = max(max_abs_diff(arena.view(n, dev), p)
                             for n, p in zip(names, plain))
    verd = arena.launch()
    v = {n: arena.view(n, dev) for n in ("ab", "sb", "s_ok", "active",
                                         "patch", "split", "patch_len",
                                         "group")}
    tpl = arena.launch_args(0)[4:8]
    o_plain = resident.mesh_arena_verify_plain(
        v["ab"], v["sb"], v["s_ok"], v["active"], *tpl, v["patch"],
        v["split"], v["patch_len"], v["group"], verify._btab(dev)).cpu()
    o_kernel = torch.from_numpy(np.stack([verd[1 + d::arena.n_shards]
                                          for d in range(arena.n_shards)]))
    sent = torch.tensor(arena.sentinel_ok)
    out["mesh_arena_verify"] = max(
        max_abs_diff(o_kernel, o_plain[:, 1:]),
        max_abs_diff(sent, o_plain[:, 0]))
    want = np.zeros(arena.capacity, bool)
    want[0] = True
    for i in keep:
        want[i + 1] = b["expect"][i]
    out["equal_expect"] = bool((verd == want).all())
    out["sentinels"] = arena.sentinel_ok
    act = arena.view("active", dev)
    resident.mesh_clear_plain(act)
    arena.deactivate_all()
    out["mesh_clear"] = max_abs_diff(arena.view("active", dev), act)
    if (out["mesh_splice"] or out["mesh_arena_verify"] or out["mesh_clear"]
            or not out["equal_expect"] or not all(arena.sentinel_ok)):
        raise AssertionError(f"K8 check failed: {out}")
    return out


def healing_phase(vs, commit, bid, seed_of, mvs, mcommit, spec, dev):
    """The self-healing fabric on the fabric phase's mesh (fabric_mesh),
    with the port's clock replaced by PhaseClock: K8's check, then,
    with the counters zeroed before and read after, the speculation
    plane on a MeshResidentArena, a lying shard, live reshards 4 -> 3 ->
    2 -> 4 of the cached sharded set and of the arena, the shard_fail
    failpoint, re-admission by half-open probes, the backend breaker and
    the degraded sr25519 route; every fallback counter must move by
    exactly what the phase injected. Returns the phase's record and
    K8's kernels rows."""
    from tendermint_tpu_torch.crypto import batch as cbatch
    from tendermint_tpu_torch.crypto.cuda import expanded
    from tendermint_tpu_torch.device import set_mesh
    from tendermint_tpu_torch.libs import clock, failpoints

    pubkeys = [v.pub_key.bytes() for v in vs.validators]
    single = expanded.get_expanded(pubkeys)  # the slice phase's set
    mesh, kind = fabric_mesh()
    set_mesh(mesh)
    phase_clock = PhaseClock()
    clock.install(phase_clock)
    try:
        return _healing(vs, commit, bid, seed_of, mvs, mcommit, spec, dev,
                        single, mesh, kind, phase_clock)
    finally:
        cbatch.reset_breakers()
        failpoints.disarm_all()
        clock.uninstall()
        expanded.set_shard_crossover(None)
        set_mesh(None)


def _healing(vs, commit, bid, seed_of, mvs, mcommit, spec, dev, single,
             mesh, kind, phase_clock):
    import numpy as np
    import torch

    from tendermint_tpu_torch.config import SpeculationConfig
    from tendermint_tpu_torch.consensus import SpeculationPlane
    from tendermint_tpu_torch.crypto import batch as cbatch
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto.batch import BatchVerifier
    from tendermint_tpu_torch.crypto.cuda import expanded, resident
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv
    from tendermint_tpu_torch.crypto.cuda import verify as tv
    from tendermint_tpu_torch.libs import failpoints
    from tendermint_tpu_torch.types.block import (BlockID, BlockIDFlag,
                                                  Commit, CommitSig,
                                                  PartSetHeader)
    from tendermint_tpu_torch.types.sign_batch import CommitSignBatch
    from tendermint_tpu_torch.types.validator_set import VerificationError
    from tendermint_tpu_torch.types.vote import Vote, VoteType

    pubkeys = [v.pub_key.bytes() for v in vs.validators]
    names = tv._mesh().names
    d_n = len(mesh)
    n_dev = len(set(mesh))
    out = {"mesh": mesh, "mesh_kind": kind, "entries": list(names),
           "k8_check": k8_check(dev)}
    kernels = wrappers()
    before_state = fallback_state()
    m0 = before_state["metrics"]

    def launched(fn, *args, counted=True, **kw):
        """fn's result and host ms, and the launches it made. A call
        outside the healing path's run (a comparison, a timing:
        counted=False) has its launches taken back out of the counts,
        so that they hold the path's own launches alone."""
        before = {k: f.launches for k, f in kernels.items()}
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: f.launches - before[k] for k, f in kernels.items()
                 if f.launches != before[k]}
        if not counted:
            for k, f in kernels.items():
                f.launches = before[k]
        return res, ms, delta

    def expect(delta, want, what):
        if delta != want:
            raise AssertionError(f"{what} launched {delta}, not {want}")

    # the healing path: counters zeroed just before, read just after
    for fn in kernels.values():
        fn.launches = 0
    # 2. speculation on the mesh: 10 bursts of 1,024 and a full hit
    h, r = commit.height, commit.round
    votes = [Vote(VoteType.PRECOMMIT, h, r, bid, cs.timestamp,
                  cs.validator_address, i, cs.signature)
             for i, cs in enumerate(commit.signatures)]
    plane = SpeculationPlane(SpeculationConfig())
    plane.begin_height(CHAIN, vs, h, r, bid)
    flush_ms = []
    per_flush = {"mesh_splice": n_dev, "mesh_arena_verify": n_dev}
    for start in range(0, len(votes), SPEC_BURST):
        for v in votes[start:start + SPEC_BURST]:
            plane.observe_precommit(v)
        _, ms, delta = launched(plane.flush_sync)
        if start == 0:  # the first flush also clears the new arena
            delta.pop("mesh_clear", None)
        expect(delta, per_flush, "a flush")
        flush_ms.append(ms)
    arena = plane._arena
    if not isinstance(arena, resident.MeshResidentArena) or \
            arena.n_shards != d_n or not all(arena.sentinel_ok):
        raise AssertionError("the plane's arena is not the mesh arena")
    served, serve_ms, delta = launched(plane.serve_commit, vs, CHAIN, bid, h,
                                       commit)
    if not served or plane.hits != 1 or delta:
        raise AssertionError(f"no full hit on the mesh: {delta}")
    template_bytes = sum(a.nbytes for a in (arena.pre, arena.pre_len,
                                            arena.suf, arena.suf_len))
    upload = arena.shard_reupload_bytes()
    if max(upload) > spec["reupload_bytes"] / d_n + template_bytes:
        raise AssertionError(f"per-shard upload {upload} over the bound")
    snapshot = [tuple(t.clone() for t in arena.launch_args(b))
                for b in range(len(arena._blocks))]
    last = list(range(len(votes) - SPEC_BURST, len(votes)))
    out.update(flush_ms=flush_ms, flush_p50_ms=statistics.median(flush_ms),
               serve_commit_ms=serve_ms, shard_reupload_bytes=upload,
               single_reupload_bytes=spec["reupload_bytes"],
               template_bytes=template_bytes)
    # 3. a lying shard: shard 2's resident sentinel signature flipped on
    # the card; the next flush (height h+1's first burst) must name it
    h2 = h + 1
    bid2 = BlockID(b"\xba" * 32, PartSetHeader(4, b"\xdc" * 32))
    cs2 = [CommitSig(BlockIDFlag.COMMIT, v.address,
                     1_753_928_100_000_000_000 + i * 1_000_003, b"")
           for i, v in enumerate(vs.validators)]
    commit2 = Commit(h2, 0, bid2, cs2)
    votes2 = []
    for i in range(3 * 256):
        pub = vs.validators[i].pub_key.bytes()
        votes2.append(Vote(VoteType.PRECOMMIT, h2, 0, bid2, cs2[i].timestamp,
                           cs2[i].validator_address, i,
                           ref.sign(seed_of[pub],
                                    commit2.vote_sign_bytes(CHAIN, i))))
    blk = arena._blocks[arena._block_of[2]]
    blk["bufs"]["sb"][int(arena._off_of[2]), 0] ^= 1
    plane.begin_height(CHAIN, vs, h2, 0, bid2)
    for v in votes2[:256]:
        plane.observe_precommit(v)
    _, lie_ms, delta = launched(plane.flush_sync)
    expect(delta, dict(per_flush, mesh_clear=n_dev), "the lying flush")
    if arena.sentinel_ok != [d != 2 for d in range(d_n)] or \
            cbatch.breaker_states()["ed25519"] != "closed" or \
            cbatch.device_breaker_states() != {names[2]: "open"}:
        raise AssertionError(f"the lying shard: {arena.sentinel_ok} "
                             f"{cbatch.device_breaker_states()}")
    lanes2 = plane._heights[h2].lanes
    if not all(lanes2[i].verdict for i in range(256)):
        raise AssertionError("the host recheck lost a verdict")
    served, _, delta = launched(plane.serve_commit, vs, CHAIN, bid, h,
                                commit)
    if not served or plane.hits != 2 or delta:
        raise AssertionError("the commit no longer serves")
    # 4. live reshard 4 -> 3: the arena at the next flush ...
    for v in votes2[256:512]:
        plane.observe_precommit(v)
    _, _, delta = launched(plane.flush_sync)
    if plane._arena is not arena or arena.n_shards != d_n - 1 or \
            not all(arena.sentinel_ok) or names[2] in arena.names:
        raise AssertionError(f"the arena did not reshard: {arena.names}")
    expect(delta, per_flush, "the resharded flush")
    arena_reshard_s = {"4->3": arena.last_reshard_s}
    # ... and the cached sharded set at the next dispatch
    expanded.set_shard_crossover(FABRIC_CROSSOVER)
    exp = expanded.get_expanded(pubkeys)
    bad = len(vs.validators) * 27 // 64
    table_reshard_s = {}

    def entry_points(n_entries, first=None):
        """verify_commit, _light and _trusting on the slice commit, then
        the corrupted commit; K5 once an entry a call (the first call
        also `first`'s launches: a reshard's K1, the probes' K4)."""
        calls = [(vs.verify_commit, (CHAIN, bid, h, commit)),
                 (vs.verify_commit_light, (CHAIN, bid, h, commit)),
                 (vs.verify_commit_light_trusting, (CHAIN, commit, 1, 3))]
        for j, (fn, args) in enumerate(calls):
            _, _, delta = launched(fn, *args)
            want = {"shard_verify": n_entries}
            if j == 0 and first:
                want.update(first)
            expect(delta, want, fn.__name__)
        good_sig = commit.signatures[bad].signature
        commit.signatures[bad].signature = good_sig[:40] + bytes(
            [good_sig[40] ^ 4]) + good_sig[41:]
        try:
            vs.verify_commit(CHAIN, bid, h, commit)
        except VerificationError as e:
            message = str(e)
        else:
            raise AssertionError("corrupted commit verified")
        finally:
            commit.signatures[bad].signature = good_sig
        if message != f"invalid signature(s) at index(es) [{bad}]":
            raise AssertionError(f"wrong rejection: {message}")
        if expanded.get_expanded(pubkeys) is not exp or \
                exp.n_shards != n_entries:
            raise AssertionError("the cached set was not resharded in place")
        return message

    def lane_for_lane():
        """The cached set's verdicts against the one-card set's, lane
        for lane (a comparison: its launches are not the path's)."""
        lanes = list(range(len(vs.validators)))
        commit.signatures[bad].signature = bytes(64)
        try:
            sbatch = CommitSignBatch(CHAIN, commit, lanes)
            sigs = [cs.signature for cs in commit.signatures]
            v_sh = exp.verify_structured(lanes, sbatch, sigs)
            v_one = single.verify_structured(lanes, sbatch, sigs)
        finally:
            commit.signatures[bad].signature = votes[bad].signature
        if not (v_sh == v_one).all() or v_sh.sum() != len(lanes) - 1:
            raise AssertionError("resharded verdicts differ from one card's")
        return len(lanes)

    rejected = entry_points(d_n - 1, {"build_tables": d_n - 1})
    table_reshard_s["4->3"] = exp.last_reshard_s
    launched(lane_for_lane, counted=False)
    # 5. device.shard_fail on a second entry: evicted at the dispatch's
    # entry, and the same dispatch rides the two survivors
    failpoints.arm("device.shard_fail", "corrupt", nth=2)
    try:
        entry_points(d_n - 2, {"build_tables": d_n - 2})
    finally:
        failpoints.disarm_all()
    table_reshard_s["3->2"] = exp.last_reshard_s
    if cbatch.evicted_devices() != sorted([names[1], names[2]]):
        raise AssertionError(f"evicted: {cbatch.evicted_devices()}")
    # 6. re-admission: past the cooldowns the next dispatch runs both
    # due probes (an 8-lane K4 launch each, on the entry's device),
    # closes the breakers and reshards back to every entry
    phase_clock.pass_cooldowns()
    entry_points(d_n, {"general_verify": 2, "build_tables": d_n})
    table_reshard_s["2->4"] = exp.last_reshard_s
    if cbatch.device_breaker_states() != {names[1]: "closed",
                                          names[2]: "closed"}:
        raise AssertionError("the probes did not re-admit the entries")
    launched(lane_for_lane, counted=False)
    for v in votes2[512:]:
        plane.observe_precommit(v)
    _, _, delta = launched(plane.flush_sync)
    expect(delta, per_flush, "the re-admitted flush")
    if arena.n_shards != d_n or not all(arena.sentinel_ok):
        raise AssertionError("the arena did not reshard back")
    arena_reshard_s["3->4"] = arena.last_reshard_s
    if not all(ln.verdict for ln in plane._heights[h2].lanes.values()):
        raise AssertionError("a height h+1 lane did not verify")
    _, probe_ms, delta = launched(cbatch._probe_ed25519, device=mesh[0],
                                  counted=False)
    expect(delta, {"general_verify": 1}, "a probe")
    # 7. the backend breaker: device.verify raises once under a 64-lane
    # BatchVerifier; the host's verdicts equal the device's
    def bv_64():
        bv = BatchVerifier()
        for i in range(64):
            sig = commit.signatures[i].signature
            if i == 7:
                sig = sig[:33] + bytes([sig[33] ^ 1]) + sig[34:]
            bv.add(vs.validators[i].pub_key, commit.vote_sign_bytes(CHAIN, i),
                   sig)
        return bv.verify()[1]

    on_device, _, delta = launched(bv_64, counted=False)
    expect(delta, {"general_verify": 1}, "the 64-lane batch")
    failpoints.arm("device.verify", "error", count=1)
    on_host, _, delta = launched(bv_64)
    expect(delta, {}, "the failed batch")
    if on_host.tolist() != on_device.tolist() or \
            cbatch.breaker_states()["ed25519"] != "open":
        raise AssertionError("the backend breaker did not take the host")
    phase_clock.pass_cooldowns()
    again, _, delta = launched(bv_64)  # the due probe, then the batch
    expect(delta, {"general_verify": 2}, "the re-admitted batch")
    if again.tolist() != on_device.tolist() or \
            cbatch.breaker_states()["ed25519"] != "closed":
        raise AssertionError("the probe did not close the backend breaker")
    # 8. sr25519 degraded: with its breaker open, 64 sr25519 lanes take
    # verify_batch_sr(device="cpu"); the verdicts equal K9's
    sr = [i for i, v in enumerate(mvs.validators)
          if v.pub_key.type_name == "sr25519"][:64]
    items = [(mvs.validators[i].pub_key, mcommit.vote_sign_bytes(CHAIN, i),
              mcommit.signatures[i].signature) for i in sr]
    pk, m, s = items[5]
    items[5] = (pk, m, s[:40] + bytes([s[40] ^ 4]) + s[41:])
    k9, _, delta = launched(sv.verify_batch_sr, [p.bytes() for p, _, _ in items],
                            [m for _, m, _ in items], [s for _, _, s in items],
                            counted=False)
    expect(delta, {"sr_verify": 1}, "K9 on 64 lanes")
    cbatch.mark_device_failed("sr25519")
    bv = BatchVerifier()
    for it in items:
        bv.add(*it)
    (_, degraded), sr_cpu_ms, delta = launched(bv.verify)
    expect(delta, {}, "the degraded sr25519 batch")
    if degraded.tolist() != k9.tolist() or degraded.sum() != 63:
        raise AssertionError("degraded sr25519 verdicts differ from K9's")
    launches = {k: kernels[k].launches for k in kernels}  # the path's alone
    # the counters moved by exactly what the phase injected
    m1 = cbatch.METRICS
    moved = {"host_fallbacks": m1["host_fallbacks"] - m0["host_fallbacks"],
             "host_rechecks": m1["host_rechecks"] - m0["host_rechecks"],
             "evictions": {f"{k[0]} {k[1]}": v - m0["evictions"].get(k, 0)
                           for k, v in m1["evictions"].items()
                           if v != m0["evictions"].get(k, 0)},
             "probes": {f"{k[0]} {k[1]}": v - m0["probes"].get(k, 0)
                        for k, v in m1["probes"].items()
                        if v != m0["probes"].get(k, 0)}}
    injected = {"host_fallbacks": 3, "host_rechecks": 1,
                "evictions": {f"{names[2]} sentinel": 1,
                              f"{names[1]} failpoint": 1},
                "probes": {"ed25519 ok": 3}}
    if moved != injected:
        raise AssertionError(f"counters moved {moved}, injected {injected}")
    rows = mesh_arena_rows(arena, snapshot, commit, last, dev)
    out.update(lie_flush_ms=lie_ms, rejected=rejected,
               table_reshard_s=table_reshard_s,
               arena_reshard_s=arena_reshard_s, probe_ms=probe_ms,
               sr_cpu_ms=sr_cpu_ms, counters_moved=moved,
               launches={k: v for k, v in launches.items() if v},
               k7_ms_per_flush=rows[-1]["ms"])
    return out, rows


def mesh_arena_rows(arena, snapshot, commit, last, dev) -> list[dict]:
    """K8 at the healing phase's main-path shapes, on the block buffers
    the plane's arena held after its tenth flush (`snapshot`, one
    launch_args tuple a device): the splice of the last burst, the
    clear, and the verify of every active lane (all devices' launches
    on their streams), each against its plain version over the
    (D, per, ...) view; with their bounds and, for the splice, the
    library call's time."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto.cuda import expanded, resident, verify

    d_n, per = arena.n_shards, arena.shard_capacity
    blocks = arena._blocks

    def view(b_args, i):
        """(D, per, ...) of the snapshot's i-th launch argument."""
        return torch.stack([
            b_args[arena._block_of[d]][i][arena._off_of[d]:
                                           arena._off_of[d] + per]
            for d in range(d_n)])

    # the splice of the last burst into copies of the blocks
    b = dict(ts=[cs.timestamp for cs in commit.signatures],
             sigs=[cs.signature for cs in commit.signatures])
    lengths = types.SimpleNamespace(pre_len=snapshot[0][5].cpu().numpy(),
                                    suf_len=snapshot[0][7].cpu().numpy())
    slots, *rows = splice_args(lengths, b, last)
    local, per_block = shard_deltas(arena, slots, *rows)
    spliced = (1, 2, 8, 9, 10, 11, 3)  # sb s_ok patch split plen group active
    bufs_k = [[snap[i].clone() for i in spliced] for snap in snapshot]
    packed = [torch.from_numpy(p).to(dev) for p in per_block]

    def k_splice():
        for bk, pk in zip(bufs_k, packed):
            resident.mesh_splice(*bk, pk)

    k_splice()
    plain = [view(snapshot, i).clone() for i in spliced]
    lp = [torch.from_numpy(p).to(dev) for p in local]
    _, p_ms = plain_ms(lambda: resident.mesh_splice_plain(plain, lp))
    got = [torch.stack([bufs_k[arena._block_of[d]][j][
        arena._off_of[d]:arena._off_of[d] + per] for d in range(d_n)])
        for j in range(7)]
    err = max(max_abs_diff(x, y) for x, y in zip(got, plain))
    k = len(last)
    row = entry("mesh_splice", err, kernel_times(k_splice, 100), p_ms, 0,
                k * (resident.ROW_BYTES + SPLICE_WRITE))
    lib = [index_copy_splice([t.clone() for t in bk], pk)
           for bk, pk in zip(bufs_k, packed)]
    lib_t = kernel_times(lambda: [f() for f in lib], 100)
    row["library_ms"] = lib_t["ms"]
    row["library_wrapper_us"] = lib_t["wrapper_us"]
    out = [row]
    # the clear of every block
    acts = [snap[3].clone() for snap in snapshot]

    def k_clear():
        for a in acts:
            resident.mesh_clear(a, per)

    k_clear()
    act_p = view(snapshot, 3).clone()
    _, p_ms = plain_ms(lambda: resident.mesh_clear_plain(act_p))
    got = torch.stack([acts[arena._block_of[d]][arena._off_of[d]:
                                                arena._off_of[d] + per]
                       for d in range(d_n)])
    out.append(entry("mesh_clear", max_abs_diff(got, act_p),
                     kernel_times(k_clear, 100), p_ms, 0, d_n * per))
    # the verify of every active lane, on every device's stream
    devices = [blk["device"] for blk in blocks]

    def k_verify():
        return verify.run_shards(devices, lambda j, _d: resident.mesh_arena_verify(
            *snapshot[j], width=arena.width))

    outs = k_verify()
    o_k = torch.stack([outs[arena._block_of[d]].to(dev)[
        arena._off_of[d]:arena._off_of[d] + per] for d in range(d_n)])
    tpl = snapshot[0][4:8]
    v = {n: view(snapshot, i) for n, i in (("ab", 0), ("sb", 1), ("s_ok", 2),
                                            ("active", 3), ("patch", 8),
                                            ("split", 9), ("patch_len", 10),
                                            ("group", 11))}
    o_p, p_ms = plain_ms(lambda: resident.mesh_arena_verify_plain(
        v["ab"], v["sb"], v["s_ok"], v["active"], *tpl, v["patch"],
        v["split"], v["patch_len"], v["group"], snapshot[0][12],
        arena.width))
    err = max_abs_diff(o_k, o_p)
    flat = {n: t.reshape(d_n * per, *t.shape[2:]) for n, t in v.items()}
    live = flat["active"].nonzero()[:, 0]
    msg, nblocks = expanded.assemble_plain(*tpl, flat["patch"][live],
                                           flat["split"][live],
                                           flat["patch_len"][live],
                                           flat["group"][live], arena.width)
    ops, _ = general_work(flat["ab"][live], flat["sb"][live], msg, nblocks,
                          flat["s_ok"][live])
    lanes = max(int(snap[0].shape[0]) for snap in snapshot)
    # as K7's: per active lane its key, signature, s_ok, patch and three
    # ints; every lane's active flag and verdict; templates, the comb
    nbytes = (live.numel() * (32 + 64 + 1 + 24 + 3 * 4) + 2 * d_n * per
              + sum(t.numel() * t.element_size() for t in tpl)
              + snapshot[0][12].numel() * 4)
    row = entry("mesh_arena_verify", err, kernel_times(k_verify, 5), p_ms,
                ops, nbytes)
    row["active_lanes"] = int(live.numel())
    row["launch"] = launch_info("mesh_arena_verify", lanes)  # largest block
    out.append(row)
    if not bool(np.all(o_k[:, 0].cpu().numpy())):
        raise AssertionError("a snapshot sentinel failed")
    return out


# -- phase 9 -------------------------------------------------------------


def timing_phase(vs, commit, dev) -> list[dict]:
    """Each kernel at the main path's shapes: time, plain time, bound,
    agreement with the plain version."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import expanded, verify
    from tendermint_tpu_torch.types.sign_batch import CommitSignBatch

    exp = expanded.get_expanded([v.pub_key.bytes() for v in vs.validators])
    n = len(vs.validators)
    lanes = list(range(n))
    sigs = [cs.signature for cs in commit.signatures]
    sbatch = CommitSignBatch(CHAIN, commit, lanes)
    idx, fields, _wf, width = exp._prepare_structured(lanes, sbatch, sigs)
    f = verify.to_device(dict(fields, idx=idx), dev)
    btab = verify._btab(dev)
    rows = []
    # K1 at the set's size
    k1 = lambda: expanded.build_tables(exp.akeys)  # noqa: E731
    tab_k, ok_k = k1()
    (tab_p, ok_p), p_ms = plain_ms(lambda: expanded.build_tables_plain(exp.akeys))
    err = max(max_abs_diff(tab_k, tab_p), max_abs_diff(ok_k, ok_p))
    del tab_p
    # per key: decompress, then 7 adds per window and 4 doublings
    # between windows (none after the last); a failed key's table is
    # the identity throughout and needs no adds
    ops = (n * DECOMPRESS + sqrt_m1_branches(exp.akeys) * MUL
           + int(ok_k.sum().item()) * (69 * 7 * ADD + 68 * 4 * DOUBLE))
    nbytes = n * 32 + tab_k.numel() * 4 + n
    del tab_k
    rows.append(entry("build_tables", err, kernel_times(k1, 3), p_ms, ops,
                      nbytes))
    rows[-1]["launch"] = launch_info("build_tables", n)
    torch.cuda.empty_cache()
    # K3 in the structured form on the commit: the main path's launch,
    # K2's assembly inside it
    sargs = (f["idx"], exp.akeys, f["sb"], f["s_ok"], exp.key_ok, exp.tables,
             btab)
    tpl = (f["pre"], f["pre_len"], f["suf"], f["suf_len"])
    sform = dict(templates=tpl,
                 patches=(f["patch"], f["split"], f["patch_len"], f["group"]),
                 width=width)
    v_k = expanded.xverify(*sargs, **sform)
    v_p, p_ms = plain_ms(lambda: expanded.shard_verify_plain(*sargs, **sform))
    err = max_abs_diff(v_k, v_p)
    if not bool(v_k[:n].all()):
        raise AssertionError("K3 rejects the valid commit")
    (m_p, nb_p), a_ms = plain_ms(lambda: expanded.assemble_plain(
        *tpl, *sform["patches"], width))
    ops, lane_bytes, msg_bytes, m = xverify_work(
        exp.akeys, exp.key_ok, f["idx"], f["sb"], f["s_ok"], m_p, nb_p)
    # and per live lane its patch, split, patch_len and group; the
    # templates; the comb
    tpl_bytes = sum(t.numel() * t.element_size() for t in tpl)
    nbytes = lane_bytes + m * (24 + 3 * 4) + tpl_bytes + btab.numel() * 4
    k3 = kernel_times(lambda: expanded.xverify(*sargs, **sform), 10)
    rows.append(entry("xverify", err, k3, p_ms, ops, nbytes))
    rows[-1]["launch"] = launch_info("xverify", int(f["idx"].shape[0]), 1)
    # K2: no launch of its own. What it adds to the launch that carries
    # it: the structured K3's times less the bytes form's on the same
    # lanes, given the rows the plain version assembles; the two forms'
    # verdicts must agree
    bform = dict(msg=m_p, nblocks=nb_p)
    k3b = kernel_times(lambda: expanded.xverify(*sargs, **bform), 10)
    err = max_abs_diff(expanded.xverify(*sargs, **bform), v_k)
    # it reads per live lane the patch and three ints, and the templates;
    # it writes no message to device memory
    row = entry("assemble", err, {k: k3[k] - k3b[k] for k in k3}, a_ms, 0,
                m * (24 + 3 * 4) + tpl_bytes)
    row.update(inside="xverify, shard_verify: the structured form",
               structured_xverify=k3, bytes_form_xverify=k3b)
    rows.append(row)
    # K4 at BatchVerifier's 64-lane shape (one 128-lane bucket)
    rows.append(k4_row("general_verify", k4_args(vs, commit, range(64),
                                                 dev), 64))
    return rows


def xverify_work(akeys, key_ok, idx, sb, s_ok, msg, nblocks):
    """K3's work (K5's too) on the lanes whose verdict is not already
    false (padding, S >= L, a bad key): (int32 products; bytes of idx,
    signature, s_ok, key_ok, key and the table entries read per lane;
    the message bytes SHA-512 reads; live lanes)."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import scalar

    ki = idx.to(torch.int64)
    live = s_ok.bool() & key_ok[ki].bool()
    m, ki, sb = int(live.sum().item()), ki[live], sb[live]
    dig_k, dig_s = lane_digits(akeys[ki], sb, msg[live], nblocks[live])
    dig_k = scalar.recode_signed(dig_k)
    # per lane: decompress R, a table add per nonzero signed digit, a
    # comb add per nonzero S nibble, + the other sum, + (-R), x8
    ops = (m * DECOMPRESS + sqrt_m1_branches(sb[:, :32]) * MUL
           + adds_after_first(dig_k) * ADD + adds_after_first(dig_s) * ADD_Z1
           + m * (2 * ADD + 3 * DOUBLE))
    msg_bytes = int((nblocks[live].to(torch.int64) * 128 - 64).sum().item())
    lane_bytes = (m * (4 + 64 + 1 + 1 + 32)
                  + int((dig_k != 0).sum().item()) * ENTRY_BYTES)
    return ops, lane_bytes, msg_bytes, m


def general_work(ab, sb, msg, nblocks, live) -> tuple[int, int]:
    """K4's work on the lanes `live` (the others' verdicts are already
    false): (int32 products, bytes read of keys, signatures, s_ok,
    nblocks and the message blocks SHA-512 reads)."""
    import torch

    ab, sb, m = ab[live], sb[live], int(live.sum().item())
    msg, nblocks = msg[live], nblocks[live]
    dig_k, dig_s = lane_digits(ab, sb, msg, nblocks)
    top = torch.where(dig_k != 0, torch.arange(69, device=ab.device)[:, None],
                      0).max(0).values  # doublings start after it
    # per lane: decompress A and R, the 16-entry table of -A (14 adds),
    # 4 doublings per window below k's top nonzero nibble, an add per
    # nonzero nibble of k and of S, + the other sum, + (-R), x8
    ops = (2 * m * DECOMPRESS
           + (sqrt_m1_branches(ab) + sqrt_m1_branches(sb[:, :32])) * MUL
           + m * 14 * ADD + int(top.sum().item()) * 4 * DOUBLE
           + adds_after_first(dig_k) * ADD + adds_after_first(dig_s) * ADD_Z1
           + m * (2 * ADD + 3 * DOUBLE))
    msg_bytes = int((nblocks.to(torch.int64) * 128 - 64).sum().item())
    return ops, m * (32 + 64 + 4 + 1) + msg_bytes


def arena_rows(arena, vs, commit, dev) -> list[dict]:
    """K6 (splice of one 1,024-row burst, clear) and K7 at the
    speculation phase's shapes, on the plane's arena as the phase left
    it: time, plain time, bound, the library call's time for the
    splice, and agreement with the plain version."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import resident

    rows = []
    n = arena.capacity
    # K6 splice: the last burst's rows again, into copies of the buffers
    b = dict(ts=[cs.timestamp for cs in commit.signatures],
             sigs=[cs.signature for cs in commit.signatures])
    keep = list(range(len(vs.validators) - SPEC_BURST, len(vs.validators)))
    args = splice_args(arena, b, keep)
    packed_np = arena.pack(*args)
    packed = torch.from_numpy(packed_np).to(dev)
    bufs_k = [t.clone() for t in arena.buffers()]
    bufs_p = [t.clone() for t in arena.buffers()]
    resident.splice(*bufs_k, packed)
    _, p_ms = plain_ms(lambda: resident.splice_plain(*bufs_p, packed))
    err = max(max_abs_diff(x, y) for x, y in zip(bufs_k, bufs_p))
    k = len(keep)
    row = entry("splice", err,
                kernel_times(lambda: resident.splice(*bufs_k, packed), 100),
                p_ms, 0, k * (resident.ROW_BYTES + SPLICE_WRITE))
    lib_t = kernel_times(index_copy_splice(bufs_p, packed), 100)
    row["library_ms"] = lib_t["ms"]
    row["library_wrapper_us"] = lib_t["wrapper_us"]
    # the burst's upload as the arena makes it (its pinned staging
    # buffer, one asynchronous copy) and as a pageable copy, and the
    # arena's whole splice of it (pack, upload, K6): host ms, medians
    row.update(
        staged_upload_ms=host_ms(lambda: arena._splice._upload(packed_np)),
        pageable_upload_ms=host_ms(
            lambda: torch.from_numpy(packed_np).to(dev)),
        arena_splice_ms=host_ms(lambda: arena.splice(*args)))
    rows.append(row)
    # K6 clear at the arena's capacity
    act_k, act_p = arena._active.clone(), arena._active.clone()
    resident.clear(act_k)
    _, p_ms = plain_ms(lambda: resident.clear_plain(act_p))
    rows.append(entry("clear", max_abs_diff(act_k, act_p),
                      kernel_times(lambda: resident.clear(act_k), 100), p_ms,
                      0, n))
    # over the active lanes the last flush verified, all of them valid
    rows.append(k7_row(arena, all_valid=True))
    return rows


def spec_arena(vs, commit, bid, dev):
    """The speculation phase's arena as its last flush leaves it, built
    without the plane: the plane's capacity (SpeculationConfig
    arena_lanes), every validator's key at slot index + 1, the
    commit's precommit template as group 1 and every signature spliced
    (12,288 lanes, 10,241 active at 10,240 validators)."""
    from tendermint_tpu_torch.config import SpeculationConfig
    from tendermint_tpu_torch.crypto.cuda import resident
    from tendermint_tpu_torch.types import canonical
    from tendermint_tpu_torch.types.vote import VoteType

    n = len(vs.validators)
    arena = resident.ResidentArena(SpeculationConfig().arena_lanes, device=dev)
    arena.install_keys([v.pub_key.bytes() for v in vs.validators])
    arena.set_template(1, *canonical.vote_sign_parts(
        CHAIN, int(VoteType.PRECOMMIT), commit.height, commit.round, bid))
    b = dict(ts=[cs.timestamp for cs in commit.signatures],
             sigs=[cs.signature for cs in commit.signatures])
    arena.splice(*splice_args(arena, b, range(n)))
    return arena


def k7_row(arena, all_valid: bool, name: str = "arena_verify") -> dict:
    """K7 over the arena's active lanes: time, plain time, bound, launch
    shape and agreement with the plain version (and, where all_valid,
    every active lane accepted)."""
    from tendermint_tpu_torch.crypto.cuda import expanded, resident

    n = arena.capacity
    largs = arena.launch_args()
    v_k = resident.arena_verify(*largs)
    v_p, p_ms = plain_ms(lambda: resident.arena_verify_plain(*largs))
    err = max_abs_diff(v_k, v_p)
    if all_valid and not bool(v_k[largs[3]].all()):
        raise AssertionError(f"{name}: K7 rejects a valid active lane")
    (ab, sbuf, s_okb, act, pre, pre_len, suf, suf_len, pat, spl, plen, grp,
     btab) = largs
    live = act.nonzero()[:, 0]
    msg, nblocks = expanded.assemble_plain(pre, pre_len, suf, suf_len,
                                           pat[live], spl[live], plen[live],
                                           grp[live], arena.width)
    ops, _ = general_work(ab[live], sbuf[live], msg, nblocks, s_okb[live])
    # per active lane: key, signature, s_ok, patch, split, patch_len and
    # group; every lane's active flag and verdict; templates and the comb
    nbytes = (live.numel() * (32 + 64 + 1 + 24 + 3 * 4) + 2 * n
              + sum(t.numel() * t.element_size()
                    for t in (pre, pre_len, suf, suf_len))
              + btab.numel() * 4)
    row = entry(name, err,
                kernel_times(lambda: resident.arena_verify(*largs), 5),
                p_ms, ops, nbytes)
    row["lanes"], row["active_lanes"] = n, int(live.numel())
    row["launch"] = launch_info(name, n)
    return row


def index_copy_splice(bufs, packed):
    """The splice of the packed delta rows into the seven buffers (K6's
    order) by seven index_copy_ calls: the library yardstick. Returns
    the call."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import resident

    k = packed.numel() // resident.ROW_BYTES
    ints = packed[:16 * k].view(torch.int32).reshape(4, k)
    rest = packed[16 * k:]
    pos = ints[0].to(torch.int64)
    d_sb = rest[:64 * k].reshape(k, 64)
    d_patch = rest[64 * k:88 * k].reshape(k, 24)
    d_sok = rest[88 * k:].to(torch.bool)
    ones = torch.ones(k, dtype=torch.bool, device=packed.device)
    sb, s_ok, patch, split, patch_len, group, active = bufs

    def library():
        sb.index_copy_(0, pos, d_sb)
        s_ok.index_copy_(0, pos, d_sok)
        patch.index_copy_(0, pos, d_patch)
        split.index_copy_(0, pos, ints[1])
        patch_len.index_copy_(0, pos, ints[2])
        group.index_copy_(0, pos, ints[3])
        active.index_copy_(0, pos, ones)

    return library


def host_ms(fn, reps: int = 20) -> float:
    """Median host milliseconds of a call of fn, synchronized."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def row_launches(name: str, launches: dict) -> int:
    """A kernels-line row's launches on the paths' runs (`launches`, by
    wrapper): its kernel's (ROW_KERNEL), or for K2 those of the launches
    that carry it (INSIDE)."""
    return sum(launches.get(k, 0) for k in
               INSIDE.get(name, (ROW_KERNEL.get(name, name),)))


def plain_ms(fn):
    """One call's result and host milliseconds, synchronized."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


def entry(name, err, times, plain, ops, nbytes) -> dict:
    """A kernels-line row: `times` is kernel_times' (device ms, wrapper
    us a call)."""
    t_ops = ops / OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if err != 0:
        raise AssertionError(f"{name} differs from its plain version: {err}")
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": err, **times, "plain_ms": plain,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


# -- the f32 phase and the fault check: child processes ------------------

# The f32 build's kernels (every field-bearing kernel; K6 does no field
# arithmetic and is the same code in both builds, and K2's assembly,
# inside K3, is the same byte rule in both). K5 and K7 are
# held in the kernels check only: the f32 path (slice, mixed) does not
# run the fabric or the speculation plane. K7 is also timed at the
# speculation arena's shape (arena_verify_spec, spec_arena).
F32_KERNELS = ("build_tables", "xverify", "general_verify", "shard_verify",
               "arena_verify", "sr_verify")
F32_CHECK_ONLY = ("shard_verify", "arena_verify", "arena_verify_spec")
CHILD_TIMEOUT_S = {"f32": 700, "fault": 240}

# A test-only kernel that stores through an address no allocation owns:
# its launch succeeds and it faults while it runs
# (cudaErrorIllegalAddress). Built by the fault check alone, never into
# the port's library.
FAULT_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void k_fault(int* p) { p[threadIdx.x] = 1; }
extern "C" int tm_fault(void* stream) {
  k_fault<<<1, 32, 0, (cudaStream_t)stream>>>((int*)16);
  return (int)cudaGetLastError();
}
"""


def run_child(phase: str, *args) -> list[dict]:
    """Run `python3 chip_smoke.py --phase <phase> args...` (the f32 child
    with TM_TPU_FIELD=f32), relay each JSON line it prints as
    {"phase": phase, "step": <its phase>, ...}, and return the lines.
    A non-zero exit or the time limit fails the parent; the child is
    killed on the way out."""
    import threading

    env = dict(os.environ)
    if phase == "f32":
        env["TM_TPU_FIELD"] = "f32"
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase", phase, *args],
        stdout=subprocess.PIPE, text=True, env=env)
    timer = threading.Timer(CHILD_TIMEOUT_S[phase], proc.kill)
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            obj = json.loads(line)
            lines.append(obj)
            if "kernels" not in obj:
                emit({"phase": phase, "step": obj.get("phase"),
                      **{k: v for k, v in obj.items() if k != "phase"}})
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"the {phase} child exited {rc}")
    return lines


def fault_child() -> int:
    """The fault check's child: a test-only kernel that faults is
    launched just before K4 inside a BatchVerifier's device call (after
    a clean call, so every buffer is already allocated). The fault
    shows at the launch's or the readback's CUDA check and must raise
    KernelError through the breaker ladder, with every breaker closed
    and no counter moved. A sticky fault poisons the context, hence a
    process of its own."""
    import ctypes

    from tendermint_tpu_torch.crypto import batch as cbatch
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto.cuda import kernels, verify

    out_dir = kernels.BUILD_ROOT.parent / "fault_check"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "fault.cu").write_text(FAULT_SOURCE)
    so = out_dir / f"libfault.{os.getpid()}.so"
    subprocess.run([kernels._nvcc(), kernels.ARCH, "-shared", "-Xcompiler",
                    "-fPIC", "-o", str(so), str(out_dir / "fault.cu")],
                   check=True)
    fault = ctypes.CDLL(str(so))
    fault.tm_fault.argtypes = [ctypes.c_void_p]
    fault.tm_fault.restype = ctypes.c_int
    seeds = [hashlib.sha256(b"fault-%d" % i).digest() for i in range(64)]
    lanes = [(ed25519.Ed25519PubKey(ref.public_key_from_seed(s)),
              b"fault lane %d" % i) for i, s in enumerate(seeds)]
    sigs = [ref.sign(s, m) for s, (_, m) in zip(seeds, lanes)]

    def verify_all():
        bv = cbatch.BatchVerifier()
        for (pk, m), sig in zip(lanes, sigs):
            bv.add(pk, m, sig)
        return bv.verify()

    if not verify_all()[0]:
        raise AssertionError("the clean call rejected its lanes")
    real = verify.general_verify

    def faulting(*a):
        rc = fault.tm_fault(kernels.stream_ptr(a[0].device))
        if rc:
            raise AssertionError(f"the faulting launch was refused: {rc}")
        return real(*a)

    faulting.launches = 0  # real() counts on the module's name
    state = fallback_state()
    verify.general_verify = faulting
    try:
        verify_all()
    except kernels.KernelError as e:
        message = str(e)
    else:
        raise AssertionError("a kernel fault did not raise KernelError")
    finally:
        verify.general_verify = real
    no_fallback("fault", state)
    code = int(message.split("CUDA error ")[1].split()[0])
    if code not in kernels.KERNEL_FAULTS:
        raise AssertionError(f"not a kernel fault: {message}")
    emit({"phase": "fault", "raised": "KernelError", "code": code,
          "message": message})
    return 0


def f32_child(i32: dict) -> int:
    """The f32 phase's child (TM_TPU_FIELD=f32): the f32 library built;
    the kernels check (K1, K3, K4, K7, K9 and K5, each against its f32
    plain version) with its verdicts held against the i32 build's
    digests `i32`; the slice and mixed paths at full width through the
    entry points, launches and outcomes as in the i32 phases; then each
    f32 kernel's time, plain time and bound (K1-K4 and K9 at the main
    path's shapes, K5 and K7 at the kernels check's, and K7 again at the
    speculation arena's, built by spec_arena). No fallback: the
    library, the kernels and the checks are the f32 build's or the
    child fails."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import expanded, kernels
    from tendermint_tpu_torch.crypto.cuda.fieldsel import F as fe
    from tendermint_tpu_torch.device import set_mesh

    if kernels.FIELD != "f32" or fe.NLIMB != 32 or FIELD != "f32":
        raise AssertionError("the f32 child runs without the f32 field")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib_path = kernels.build()
    emit({"phase": "build", "library": str(lib_path.relative_to(
        kernels.BUILD_ROOT.parent.parent)),
        "seconds": time.perf_counter() - t0,
        "nvcc_seconds": kernels.BUILD_INFO.get("seconds"),
        "ptxas": {k: kernel_ptxas(k) for k in F32_KERNELS}})
    t0 = time.perf_counter()
    state = fallback_state()
    checks = kernel_phase(256, 1024, dev)
    mesh, _kind = fabric_mesh()
    set_mesh(mesh)
    expanded.set_shard_crossover(FABRIC_CROSSOVER)
    try:
        k5 = k5_check(dev)
        k5_row = k5_check_row()
    finally:
        expanded.set_shard_crossover(None)
        set_mesh(None)
    no_fallback("f32 kernels", state)
    verdicts = dict(checks.pop("verdicts"), **k5.pop("verdicts"))
    differ = sorted(k for k in set(i32) | set(verdicts)
                    if i32.get(k) != verdicts.get(k))
    if differ:
        raise AssertionError(f"f32 verdicts differ from the i32 build's: "
                             f"{differ}")
    emit({"phase": "kernels", "lanes": 1024, "keys": 256, "checks": checks,
          "k5_check": k5, "verdicts_equal_i32": sorted(verdicts),
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    vs, commit, bid, _seed_of = make_commit(N_VALIDATORS)
    setup_s = time.perf_counter() - t0
    state = fallback_state()
    res = slice_phase(vs, commit, bid)
    no_fallback("f32 slice", state)
    emit(dict(phase="slice", validators=N_VALIDATORS, setup_s=setup_s, **res))
    t0 = time.perf_counter()
    mvs, mcommit, mbid, secret_of = make_mixed_commit(N_VALIDATORS)
    setup_s = time.perf_counter() - t0
    state = fallback_state()
    mixed = mixed_phase(mvs, mcommit, mbid, secret_of, dev)
    no_fallback("f32 mixed", state)
    emit(dict(phase="mixed", validators=N_VALIDATORS, setup_s=setup_s,
              seconds=time.perf_counter() - t0, **mixed))
    state = fallback_state()
    rows = timing_phase(vs, commit, dev)
    # K2's assembly does no field arithmetic: its row is the i32 run's
    rows = [r for r in rows if r["name"] != "assemble"]
    rows += [sr_row(mvs, mcommit, dev), k4_mixed_row(mvs, mcommit, dev),
             k5_row, k7_row(KEEP["arena"], all_valid=False),
             k7_row(spec_arena(vs, commit, bid, dev), all_valid=True,
                    name="arena_verify_spec")]
    no_fallback("f32 timing", state)
    launches = {}
    for path in (res, mixed):
        for kernel, count in path["launches"].items():
            launches[kernel] = launches.get(kernel, 0) + count
    for r in rows:
        r["launches"] = row_launches(r["name"], launches)
        r["ptxas"] = kernel_ptxas(r["name"])
        r["on_f32_path"] = r["name"] not in F32_CHECK_ONLY
        r["name"] += "_f32"
    emit({"kernels": rows})
    return 0


def f32_phase(i32_digests: dict, res: dict, mixed: dict, rows: list) -> list:
    """Run the f32 child, relay its lines, hold its outcomes to the i32
    phases', print the two fields' p50s and kernel times side by side,
    and return its kernels rows."""
    lines = run_child("f32", "--i32", json.dumps(i32_digests))
    step = {o.get("phase"): o for o in lines}
    f32_rows = next(o["kernels"] for o in lines if "kernels" in o)
    for name, i32_res in (("slice", res), ("mixed", mixed)):
        for key in ("rejected", "launches"):
            if step[name][key] != i32_res[key]:
                raise AssertionError(f"f32 {name} {key}: {step[name][key]} "
                                     f"against i32 {i32_res[key]}")
    i32_ms = {r["name"]: r["ms"] for r in rows}
    i32_ms["arena_verify_spec"] = i32_ms["arena_verify"]  # the same shape
    emit({"phase": "f32", "step": "compare",
          "verify_commit_p50_ms": {
              "i32": res["verify_commit_p50_ms"],
              "f32": step["slice"]["verify_commit_p50_ms"]},
          "mixed_verify_commit_p50_ms": {
              "i32": mixed["verify_commit_p50_ms"],
              "f32": step["mixed"]["verify_commit_p50_ms"]},
          "kernel_ms": {r["name"]: {"f32": r["ms"],
                                    "i32": i32_ms.get(r["name"][:-4])}
                        for r in f32_rows}})
    return f32_rows


def main() -> int:
    import torch

    if "--phase" in sys.argv:
        phase = sys.argv[sys.argv.index("--phase") + 1]
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 2
        if phase == "fault":
            rc = fault_child()
            sys.stdout.flush()
            os._exit(rc)  # the poisoned context is not torn down
        return f32_child(json.loads(sys.argv[sys.argv.index("--i32") + 1]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if FIELD != "i32":
        print("chip_smoke: run it without TM_TPU_FIELD (its f32 phase sets "
              "the variable for its own child)", file=sys.stderr)
        return 2
    from tendermint_tpu_torch.crypto.cuda import kernels

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    from tendermint_tpu_torch.crypto import ed25519

    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "host_openssl": ed25519._HAVE_OPENSSL})
    t0 = time.perf_counter()
    kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": kernels.BUILD_INFO.get("seconds"),
          "ptxas": {k: kernel_ptxas(k) for k in SOURCES}})
    t0 = time.perf_counter()
    state = fallback_state()
    checks = kernel_phase(256, 1024, torch.device("cuda"))
    no_fallback("kernels", state)
    emit({"phase": "kernels", "lanes": 1024, "keys": 256, "checks": checks,
          "seconds": time.perf_counter() - t0, "card": smi})
    t0 = time.perf_counter()
    vs, commit, bid, seed_of = make_commit(N_VALIDATORS)
    setup_s = time.perf_counter() - t0
    state = fallback_state()
    res = slice_phase(vs, commit, bid)
    no_fallback("slice", state)
    emit(dict(phase="slice", validators=N_VALIDATORS, setup_s=setup_s,
              card=smi, **res))
    t0 = time.perf_counter()
    state = fallback_state()
    spec, arena = speculation_phase(vs, commit, bid)
    no_fallback("speculation", state)
    emit(dict(phase="speculation", validators=N_VALIDATORS,
              bursts=len(spec["flushes"]), burst=SPEC_BURST,
              verify_commit_p50_ms=res["verify_commit_p50_ms"],
              seconds=time.perf_counter() - t0, card=smi, **spec))
    t0 = time.perf_counter()
    mvs, mcommit, mbid, secret_of = make_mixed_commit(N_VALIDATORS)
    setup_s = time.perf_counter() - t0
    state = fallback_state()
    mixed = mixed_phase(mvs, mcommit, mbid, secret_of, torch.device("cuda"))
    no_fallback("mixed", state)
    emit(dict(phase="mixed", validators=N_VALIDATORS, setup_s=setup_s,
              seconds=time.perf_counter() - t0, card=smi, **mixed))
    t0 = time.perf_counter()
    state = fallback_state()
    fabric, k5 = fabric_phase(vs, commit, bid, mvs, mcommit, mbid,
                              mixed["rejected"], torch.device("cuda"))
    no_fallback("fabric", state)
    emit(dict(phase="fabric", validators=N_VALIDATORS,
              crossover=FABRIC_CROSSOVER,
              one_card_verify_commit_p50_ms=res["verify_commit_p50_ms"],
              seconds=time.perf_counter() - t0, card=smi, **fabric))
    t0 = time.perf_counter()
    healing, k8 = healing_phase(vs, commit, bid, seed_of, mvs, mcommit, spec,
                                torch.device("cuda"))
    emit(dict(phase="healing", validators=N_VALIDATORS,
              seconds=time.perf_counter() - t0, card=smi, **healing))
    state = fallback_state()
    rows = timing_phase(vs, commit, torch.device("cuda"))
    rows += arena_rows(arena, vs, commit, torch.device("cuda"))
    rows.append(sr_row(mvs, mcommit, torch.device("cuda")))
    rows.append(k4_mixed_row(mvs, mcommit, torch.device("cuda")))
    rows.append(k5)
    rows += k8
    no_fallback("timing", state)
    t0 = time.perf_counter()
    run_child("fault")
    emit({"phase": "fault", "seconds": time.perf_counter() - t0, "card": smi})
    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the child needs 3.3 GB of f32 tables
    f32_rows = f32_phase(dict(checks["verdicts"],
                              **fabric["k5_check"]["verdicts"]),
                         res, mixed, rows)
    emit({"phase": "f32", "step": "done", "card": smi,
          "seconds": time.perf_counter() - t0})
    launches = {}
    for path in (res, spec, mixed, fabric, healing):  # each path's run
        for kernel, count in path["launches"].items():
            launches[kernel] = launches.get(kernel, 0) + count
    for r in rows:
        r["launches"] = row_launches(r["name"], launches)
        if not r["launches"]:
            raise AssertionError(f"{r['name']}: no launch on the main path")
        r["ptxas"] = kernel_ptxas(r["name"])
    emit({"phase": "timing", "card": smi,
          "tolerance": "exact: max_abs_err 0 against the plain version",
          "launch": {r["name"]: r["launch"] for r in rows + f32_rows
                     if "launch" in r}})
    emit({"kernels": rows + f32_rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
