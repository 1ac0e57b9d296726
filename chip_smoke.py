#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name and power limit (nvidia-smi);
2. build — the CUDA kernels built from tendermint_tpu_torch/csrc;
3. kernels — each of K1-K4 against its plain PyTorch version on an
   adversarial batch (1,024 lanes over 256 keys): verdicts
   bit-identical, tables and sign bytes identical;
4. slice — a 10,240-validator set and a signed 10,240-signature commit
   through ValidatorSet.verify_commit, verify_commit_light and
   verify_commit_light_trusting (trust 1/3), a corrupted signature that
   must be named, and a 64-lane BatchVerifier; the launch counters are
   zeroed just before and read just after, and every kernel must have
   launched;
5. timing — each kernel at the main path's shapes: CUDA-event time,
   the plain version's time, its bound, and its agreement with the
   plain version on those inputs.

Then the kernels line, the nvidia-smi line and, last,
{"ok": true, "device": {...}}. Any failure raises (exit code 1); no
phase is caught. Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

N_VALIDATORS = 10_240
CHAIN = "smoke-chain"
# H100 SXM published peaks (NVIDIA H100 datasheet for HBM3 bandwidth;
# Hopper white paper for the int32 rate: 132 SMs x 64 INT32 lanes x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# The operation bound counts the int32 x int32 -> int64 products of the
# field multiplies the function needs, in radix 2^25.5 (ten limbs): 100
# for a multiply, 55 for a squaring (the kernels' fe_sqr reuses fe_mul
# and so does 100). Point ops use the reference's formulas; SHA-512, the
# fold, additions and carries are not counted, so the bound is a floor.
MUL, SQR = 100, 55
ADD = 9 * MUL                     # add-2008-hwcd-3 (ge_add)
ADD_Z1 = 8 * MUL                  # Z2 = 1: the comb add (ge_add_z1)
DOUBLE = 4 * SQR + 4 * MUL        # dbl-2008-hwcd (ge_double)
DECOMPRESS = 255 * SQR + 19 * MUL  # + MUL where x * sqrt(-1) is taken
ENTRY_BYTES = 4 * 10 * 4          # one table entry: X, Y, Z, T x 10 int32

REPLACES = {
    "build_tables": "tendermint_tpu/crypto/tpu/expanded.py:128",
    "assemble": "tendermint_tpu/crypto/tpu/expanded.py:318",
    "xverify": "tendermint_tpu/crypto/tpu/expanded.py:186",
    "general_verify": "tendermint_tpu/crypto/tpu/verify.py:173",
}
SOURCES = {
    "build_tables": "tendermint_tpu_torch/csrc/build_tables.cu",
    "assemble": "tendermint_tpu_torch/csrc/assemble.cu",
    "xverify": "tendermint_tpu_torch/csrc/xverify.cu",
    "general_verify": "tendermint_tpu_torch/csrc/general_verify.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def wrappers():
    from tendermint_tpu_torch.crypto.cuda import expanded, verify

    return {"build_tables": expanded.build_tables,
            "assemble": expanded.assemble,
            "xverify": expanded.xverify,
            "general_verify": verify.general_verify}


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up."""
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


def ptxas_summary(log: str) -> dict:
    """The kernel's own lines of an `nvcc -Xptxas -v` report: registers,
    stack frame and spills of the __global__ function."""
    lines = [ln.strip() for ln in log.splitlines()]
    out = {}
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and "k_" in ln and i + 1 < len(lines):
            out["frame"] = lines[i + 1]
        if ln.startswith("ptxas info") and "Used" in ln and "registers" in ln:
            out["registers"] = ln.split(":", 1)[1].strip()
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
    from tendermint_tpu_torch.crypto.cuda import expanded, field, verify
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
    canon_eq = bool(torch.equal(
        field.canonical(tab_k.reshape(-1, 10).T.to(torch.int64)),
        field.canonical(tab_p.reshape(-1, 10).T.to(torch.int64))))
    out["build_tables"] = dict(
        limbs_equal=bool(torch.equal(tab_k, tab_p)), canonical_equal=canon_eq,
        ok_equal=bool(torch.equal(ok_k, ok_p)),
        key_ok_0_1=ok_k.cpu().tolist()[:2])
    if not (out["build_tables"]["limbs_equal"] and canon_eq
            and out["build_tables"]["ok_equal"]):
        raise AssertionError(f"K1 differs from its plain version: {out}")
    if ok_k.cpu().tolist()[:2] != [False, True]:
        raise AssertionError("K1 key_ok: undecodable / small-order keys")
    exp = expanded.ExpandedKeys(b["pubkeys"], device=dev)
    # K3 through the bytes path, against the plain version and expect.
    idx, packed, wf = exp._prepare(b["idx"], b["msgs"], b["sigs"])
    t = verify.to_device(dict(packed, idx=idx), dev)
    args = (t["idx"], exp.akeys, t["sb"], t["msg"], t["nblocks"], t["s_ok"],
            exp.key_ok, exp.tables, verify._btab(dev))
    v_k = expanded.xverify(*args)
    v_p = expanded.xverify_plain(*args)
    got = v_k.cpu().numpy()[:n_lanes] & wf
    out["xverify"] = dict(equal_plain=bool(torch.equal(v_k, v_p)),
                          equal_expect=bool((got == expect).all()))
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
    out["general_verify"] = dict(
        equal_plain=bool(torch.equal(verify.general_verify(*gargs),
                                     verify.general_verify_plain(*gargs))),
        equal_expect=bool((g == expect).all()))
    # K2: sign bytes of a structured commit, against the plain version
    # and against the host's own padding of the materialized bytes.
    spubs, commit = structured_commit(n_lanes, seed=2)
    sexp = expanded.ExpandedKeys(spubs, device=dev)
    lanes = list(range(n_lanes))
    sbatch = CommitSignBatch(CHAIN, commit, lanes)
    sigs = [cs.signature for cs in commit.signatures]
    sidx, fields, _wf, width = sexp._prepare_structured(lanes, sbatch, sigs)
    f = verify.to_device(dict(fields), dev)
    aargs = (f["pre"], f["pre_len"], f["suf"], f["suf_len"], f["patch"],
             f["split"], f["patch_len"], f["group"], width)
    m_k, nb_k = expanded.assemble(*aargs)
    m_p, nb_p = expanded.assemble_plain(*aargs)
    host = verify.pack_sig_msg(fields["sb"][:n_lanes], sbatch.materialize())
    hw = host["msg"].shape[1]
    m_host = m_k.cpu().numpy()[:n_lanes]
    out["assemble"] = dict(
        equal_plain=bool(torch.equal(m_k, m_p) and torch.equal(nb_k, nb_p)),
        equal_host=bool((m_host[:, :hw] == host["msg"]).all()
                        and (m_host[:, hw:] == 0).all()
                        and (nb_k.cpu().numpy()[:n_lanes]
                             == host["nblocks"]).all()))
    sv = sexp.verify_structured(lanes, sbatch, sigs)
    out["assemble"]["commit_verifies"] = bool(sv.all())
    for name in ("build_tables", "xverify", "general_verify", "assemble"):
        if not all(out[name].values()):
            raise AssertionError(f"{name} check failed: {out[name]}")
    for name, fn in wrappers().items():
        out[name]["launches"] = fn.launches - before[name]
    if dev.type == "cuda":  # CUDA-event time at this phase's shapes
        out["build_tables"]["ms"] = cuda_ms(
            lambda: expanded.build_tables(akeys), 3)
        out["xverify"]["ms"] = cuda_ms(lambda: expanded.xverify(*args), 5)
        out["general_verify"]["ms"] = cuda_ms(
            lambda: verify.general_verify(*gargs), 5)
        out["assemble"]["ms"] = cuda_ms(lambda: expanded.assemble(*aargs), 20)
    return out


# -- phase 4 -------------------------------------------------------------


def make_commit(n: int):
    """n validators of equal power and a commit signed by all of them
    (bench.py's shape: one block id, per-slot timestamps)."""
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
    return vs, commit, bid


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
    launches = {name: fn.launches for name, fn in wrappers().items()}
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
    (uploads, K2, K3, verdict readback). Its launches are counted
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


def timing_phase(vs, commit, dev) -> list[dict]:
    """Each kernel at the main path's shapes: time, plain time, bound,
    agreement with the plain version."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import expanded, scalar, verify
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

    def plain_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

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
    rows.append(entry("build_tables", err, cuda_ms(k1, 3), p_ms, ops, nbytes))
    torch.cuda.empty_cache()
    # K2 at the commit's shape
    aargs = (f["pre"], f["pre_len"], f["suf"], f["suf_len"], f["patch"],
             f["split"], f["patch_len"], f["group"], width)
    m_k, nb_k = expanded.assemble(*aargs)
    (m_p, nb_p), p_ms = plain_ms(lambda: expanded.assemble_plain(*aargs))
    err = max(max_abs_diff(m_k, m_p), max_abs_diff(nb_k, nb_p))
    nbytes = (sum(f[k].numel() * f[k].element_size() for k in
                  ("pre", "pre_len", "suf", "suf_len", "patch", "split",
                   "patch_len", "group"))
              + m_k.numel() + nb_k.numel() * 4)
    rows.append(entry("assemble", err,
                      cuda_ms(lambda: expanded.assemble(*aargs), 20),
                      p_ms, 0, nbytes))
    # K3 on the assembled commit
    xargs = (f["idx"], exp.akeys, f["sb"], m_k, nb_k, f["s_ok"], exp.key_ok,
             exp.tables, btab)
    v_k = expanded.xverify(*xargs)
    v_p, p_ms = plain_ms(lambda: expanded.xverify_plain(*xargs))
    err = max_abs_diff(v_k, v_p)
    if not bool(v_k[:n].all()):
        raise AssertionError("K3 rejects the valid commit")
    ki = f["idx"].to(torch.int64)
    # lanes whose verdict is not already false (padding, S >= L, a bad
    # key): only these need the curve work
    live = f["s_ok"].bool() & exp.key_ok[ki].bool()
    m, ki, sb = int(live.sum().item()), ki[live], f["sb"][live]
    dig_k, dig_s = lane_digits(exp.akeys[ki], sb, m_k[live], nb_k[live])
    dig_k = scalar.recode_signed(dig_k)
    # per lane: decompress R, a table add per nonzero signed digit, a
    # comb add per nonzero S nibble, + the other sum, + (-R), x8
    ops = (m * DECOMPRESS + sqrt_m1_branches(sb[:, :32]) * MUL
           + adds_after_first(dig_k) * ADD + adds_after_first(dig_s) * ADD_Z1
           + m * (2 * ADD + 3 * DOUBLE))
    # idx, signature, s_ok, key_ok, nblocks and key per lane, the
    # message bytes its SHA-512 reads, one table entry per nonzero
    # digit, and the comb table
    msg_bytes = int((nb_k[live].to(torch.int64) * 128 - 64).sum().item())
    nbytes = (m * (4 + 64 + 1 + 1 + 4 + 32) + msg_bytes
              + int((dig_k != 0).sum().item()) * ENTRY_BYTES
              + btab.numel() * 4)
    rows.append(entry("xverify", err,
                      cuda_ms(lambda: expanded.xverify(*xargs), 10),
                      p_ms, ops, nbytes))
    # K4 at BatchVerifier's 64-lane shape (one 128-lane bucket)
    pubs = [vs.validators[i].pub_key.bytes() for i in range(64)]
    msgs = [commit.vote_sign_bytes(CHAIN, i) for i in range(64)]
    dp, dm, ds = verify._dummy_triple()
    pk = verify.to_device(verify.pack_batch(
        pubs + [dp] * 64, msgs + [dm] * 64, sigs[:64] + [ds] * 64), dev)
    gargs = (pk["ab"], pk["sb"], pk["msg"], pk["nblocks"], pk["s_ok"], btab)
    g_k = verify.general_verify(*gargs)
    g_p, p_ms = plain_ms(lambda: verify.general_verify_plain(*gargs))
    err = max_abs_diff(g_k, g_p)
    live = pk["s_ok"].bool()  # S >= L: the verdict is already false
    ab, sb, m = pk["ab"][live], pk["sb"][live], int(live.sum().item())
    dig_k, dig_s = lane_digits(ab, sb, pk["msg"][live], pk["nblocks"][live])
    top = torch.where(dig_k != 0, torch.arange(69, device=dev)[:, None],
                      0).max(0).values  # doublings start after it
    # per lane: decompress A and R, the 16-entry table of -A (14 adds),
    # 4 doublings per window below k's top nonzero nibble, an add per
    # nonzero nibble of k and of S, + the other sum, + (-R), x8
    ops = (2 * m * DECOMPRESS
           + (sqrt_m1_branches(ab) + sqrt_m1_branches(sb[:, :32])) * MUL
           + m * 14 * ADD + int(top.sum().item()) * 4 * DOUBLE
           + adds_after_first(dig_k) * ADD + adds_after_first(dig_s) * ADD_Z1
           + m * (2 * ADD + 3 * DOUBLE))
    msg_bytes = int((pk["nblocks"][live].to(torch.int64) * 128
                     - 64).sum().item())
    nbytes = m * (32 + 64 + 4 + 1) + msg_bytes + btab.numel() * 4
    rows.append(entry("general_verify", err,
                      cuda_ms(lambda: verify.general_verify(*gargs), 10),
                      p_ms, ops, nbytes))
    return rows


def entry(name, err, ms, plain, ops, nbytes) -> dict:
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if err != 0:
        raise AssertionError(f"{name} differs from its plain version: {err}")
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tendermint_tpu_torch.crypto.cuda import kernels

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": kernels.BUILD_INFO.get("seconds"),
          "ptxas": {k: ptxas_summary(v)
                    for k, v in kernels.BUILD_INFO.get("ptxas", {}).items()}})
    t0 = time.perf_counter()
    checks = kernel_phase(256, 1024, torch.device("cuda"))
    emit({"phase": "kernels", "lanes": 1024, "keys": 256, "checks": checks,
          "seconds": time.perf_counter() - t0, "card": smi})
    t0 = time.perf_counter()
    vs, commit, bid = make_commit(N_VALIDATORS)
    setup_s = time.perf_counter() - t0
    res = slice_phase(vs, commit, bid)
    emit(dict(phase="slice", validators=N_VALIDATORS, setup_s=setup_s,
              card=smi, **res))
    rows = timing_phase(vs, commit, torch.device("cuda"))
    for r in rows:
        r["launches"] = res["launches"][r["name"]]
    emit({"phase": "timing", "card": smi,
          "tolerance": "exact: max_abs_err 0 against the plain version"})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
