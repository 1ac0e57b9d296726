#!/usr/bin/env python3
"""Time K3/K5 and K4/K9 at each candidate launch shape, to choose
TM_XV_WARPS, TM_X4_LANES and TM_X4_WARPS; time K7 in both fields.

    python3 sweep_warps.py [xv | x4 | k7] [--tree DIR]

With no argument the xv and x4 families are swept; `xv` sweeps K3 and
K5 only, `x4` K4 and K9 only, `k7` times K7 alone.

TM_XV_WARPS (tendermint_tpu_torch/csrc/common.cuh) is the number of
warps a block of K3 (xverify.cu) and K5 (shard_verify.cu) runs for its
32 lanes, a compile-time constant of each field's build. For each field
(a child process with TM_TPU_FIELD set, since the field is chosen at
import) this script builds the kernel library once for each candidate
count (kernels.build with -DTM_XV_WARPS=W: i32 4, 8 and 16; f32 4 and
8, since the f32 build's 255 registers a thread allow at most 256
threads a block) and, on chip_smoke.py's 10,240-validator commit:

- K1 once, with the default build: its tables against its plain
  version limb for limb, its CUDA-event time, and each of its two
  launches' device time by torch.profiler (the chain's, the rows');
- for each W: K3 on the whole commit on one card, and K5 on the
  commit's four 2,560-key shards (3,072 lanes a shard, the structured
  form, the fabric phase's shapes), one shard on one stream and all
  four on four streams; every verdict against the plain version; the
  CUDA-event times, the launch shapes (resident warps an SM) and the
  ptxas lines.

TM_X4_LANES and TM_X4_WARPS (common.cuh) are the lanes and warps a
block of K4 (general_verify.cu) and K9 (sr_verify.cu) runs: TM_X4_LANES
/ 8 chain warps, the digits and R warps, and comb warps. For each
candidate (lanes, warps) (X4_CANDIDATES; under f32 at most 8 warps) the
child builds the library with both defines and, on chip_smoke.py's
10,240-validator mixed commit: K4 on 64 of its ed25519 lanes (the
64-lane BatchVerifier's 128-lane bucket) and on all 5,120 (one
8,192-lane bucket), K9 on its 5,120 sr25519 lanes; every verdict
against the plain version; the CUDA-event times, the launch shapes and
the ptxas lines.

`k7` times K7 (arena_verify.cu), with the default build of each
field, on chip_smoke.py's two arenas: the kernels check's (1,024 lanes,
821 active, adversarial) and the speculation arena (spec_arena: 12,288
lanes, 10,241 active, the 10,240-validator commit); its verdicts
against the plain version (and the check arena's digest, which
chip_smoke.py holds to VERDICT_DIGESTS), the CUDA-event time, the
launch shape where the library exports one, and the ptxas lines.
`--tree DIR` runs the children on the tendermint_tpu_torch package of
another checkout (an older commit unpacked with git archive), built
into that checkout's build/ directory: the way to time the parent's
kernels in the same call.

Each child prints one JSON line per measurement, relayed with its
field; then the card's name and power limit. Needs one CUDA device;
exits 2 without one, 1 on any disagreement.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

import chip_smoke as cs

CANDIDATES = {"i32": (4, 8, 16), "f32": (4, 8)}
X4_CANDIDATES = {"i32": ((8, 4), (16, 6), (32, 7), (32, 8)),
                 "f32": ((8, 4), (16, 6), (32, 8))}
FAMILIES = ("xv", "x4", "k7")
DEFAULT_FAMILIES = ("xv", "x4")
CHILD_TIMEOUT_S = 600


def device_ms(fn) -> dict:
    """Device milliseconds of each kernel one call of fn launches, by
    torch.profiler (after a warm-up call); {} where the profiler shows
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        name = e.key.split("(")[0]
        if name.startswith("k_") and us:
            out[name] = us / 1e3 / max(e.count, 1)
    return out


def child(field: str, families) -> int:
    rc = 0
    if "xv" in families:
        rc |= xv_child(field)
    if "x4" in families:
        rc |= x4_child(field)
    if "k7" in families:
        rc |= k7_child(field)
    return rc


def xv_child(field: str) -> int:
    import torch

    from tendermint_tpu_torch.crypto.cuda import expanded, kernels, verify
    from tendermint_tpu_torch.device import set_mesh
    from tendermint_tpu_torch.types.sign_batch import CommitSignBatch

    if kernels.FIELD != field:
        raise AssertionError(f"the {field} child runs the {kernels.FIELD} field")
    dev = torch.device("cuda")
    kernels.build()
    vs, commit, _bid, _seeds = cs.make_commit(cs.N_VALIDATORS)
    keys = [v.pub_key.bytes() for v in vs.validators]
    lanes = list(range(len(keys)))
    sigs = [c.signature for c in commit.signatures]
    sbatch = CommitSignBatch(cs.CHAIN, commit, lanes)
    one = expanded.ExpandedKeys(keys, device=dev)
    tab_k, ok_k = expanded.build_tables(one.akeys)
    tab_p, ok_p = expanded.build_tables_plain(one.akeys)
    equal = bool(torch.equal(tab_k, tab_p) and torch.equal(ok_k, ok_p))
    del tab_k, tab_p
    cs.emit({"kernel": "build_tables", "keys": len(keys), "limbs_equal": equal,
             "ms": cs.cuda_ms(lambda: expanded.build_tables(one.akeys), 3),
             "launch_ms": device_ms(lambda: expanded.build_tables(one.akeys)),
             "launch": kernels.launch_shapes("tm_build_tables_shape",
                                             len(keys), launches=2),
             "ptxas": cs.kernel_ptxas("build_tables")})
    if not equal:
        return 1
    idx, fields, _wf, width = one._prepare_structured(lanes, sbatch, sigs)
    f = verify.to_device(dict(fields, idx=idx), dev)
    msg, nblocks = expanded.assemble(
        f["pre"], f["pre_len"], f["suf"], f["suf_len"], f["patch"],
        f["split"], f["patch_len"], f["group"], width)
    xargs = (f["idx"], one.akeys, f["sb"], msg, nblocks, f["s_ok"],
             one.key_ok, one.tables, verify._btab(dev))
    want3 = expanded.xverify_plain(*xargs)
    if not bool(want3[:len(keys)].all()):
        raise AssertionError("the plain K3 rejects the valid commit")
    set_mesh(["cuda:0"] * cs.LOGICAL_SHARDS)
    expanded.set_shard_crossover(cs.FABRIC_CROSSOVER)
    try:
        return _sweep(field, dev, keys, lanes, sigs, sbatch, xargs, want3)
    finally:
        expanded.set_shard_crossover(None)
        set_mesh(None)


def _sweep(field, dev, keys, lanes, sigs, sbatch, xargs, want3) -> int:
    import torch

    from tendermint_tpu_torch.crypto.cuda import expanded, kernels, verify

    exp = expanded.ExpandedKeys(keys)
    if not exp.sharded:
        raise AssertionError("the set did not shard")
    sidx, fields, _wf, width = exp._prepare_structured(lanes, sbatch, sigs)
    tpl = verify.to_device({k: fields[k] for k in exp._S_REPL}, dev)
    lidx, routed, _slot = exp._route(
        sidx, {k: v for k, v in fields.items() if k not in exp._S_REPL})
    calls = []
    for d, shard_dev in enumerate(exp.mesh):
        calls.append(exp._k5_args(d, shard_dev, lidx, routed,
                                  tuple(tpl[k] for k in exp._S_REPL), width))
    want5 = [expanded.shard_verify_plain(*a, **kw) for a, kw in calls]

    def k5(d):
        return expanded.shard_verify(*calls[d][0], **calls[d][1])

    rc = 0
    for w in CANDIDATES[field]:
        kernels.use_library(kernels.build(defines=(f"TM_XV_WARPS={w}",)))
        equal = bool(torch.equal(expanded.xverify(*xargs), want3) and all(
            torch.equal(k5(d), want5[d]) for d in range(len(calls))))
        n3, n5 = int(xargs[0].shape[0]), int(calls[0][0][0].shape[0])
        cs.emit({
            "warps": w, "verdicts_equal_plain": equal,
            "xverify_ms": cs.cuda_ms(lambda: expanded.xverify(*xargs), 10),
            "xverify_lanes": n3,
            "shard_verify_one_ms": cs.cuda_ms(lambda: k5(0), 10),
            "shard_verify_four_ms": cs.cuda_ms(lambda: verify.run_shards(
                exp.mesh, lambda d, _dev: k5(d)), 10),
            "shard_verify_lanes": n5,
            "launch": {
                "xverify": kernels.launch_shapes("tm_xverify_shape", n3),
                "shard_verify": kernels.launch_shapes(
                    "tm_shard_verify_shape", n5, 1)},
            "ptxas": {k: cs.kernel_ptxas(k)
                      for k in ("xverify", "shard_verify")}})
        rc |= not equal
    kernels.use_library(None)
    return rc


def x4_child(field: str) -> int:
    """K4 and K9 at each X4_CANDIDATES shape on the mixed commit."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import kernels, verify
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv

    if kernels.FIELD != field:
        raise AssertionError(f"the {field} child runs the {kernels.FIELD} field")
    dev = torch.device("cuda")
    vs, commit, _bid, _secret_of = cs.make_mixed_commit(cs.N_VALIDATORS)
    by_type = {"ed25519": [], "sr25519": []}
    for i, v in enumerate(vs.validators):
        by_type[v.pub_key.type_name].append(i)
    ed, sr = by_type["ed25519"], by_type["sr25519"]
    calls = {
        "general_verify_128": (verify.general_verify,
                               cs.k4_args(vs, commit, ed[:64], dev)),
        "general_verify_8192": (verify.general_verify,
                                cs.k4_args(vs, commit, ed, dev)),
        "sr_verify_5120": (sv.sr_verify, cs.sr_args(
            [vs.validators[i].pub_key.bytes() for i in sr],
            [commit.vote_sign_bytes(cs.CHAIN, i) for i in sr],
            [commit.signatures[i].signature for i in sr], dev)[0])}
    plain = {"general_verify": verify.general_verify_plain,
             "sr_verify": sv.sr_verify_plain}
    want = {k: plain[fn.__name__](*args) for k, (fn, args) in calls.items()}
    rc = 0
    for lanes, warps in X4_CANDIDATES[field]:
        kernels.use_library(kernels.build(
            defines=(f"TM_X4_LANES={lanes}", f"TM_X4_WARPS={warps}")))
        equal = all(torch.equal(fn(*args), want[k])
                    for k, (fn, args) in calls.items())
        cs.emit({
            "lanes_a_block": lanes, "warps": warps,
            "verdicts_equal_plain": equal,
            "ms": {k: cs.cuda_ms(lambda: fn(*args), 10)
                   for k, (fn, args) in calls.items()},
            "launch": {k: kernels.launch_shapes(
                f"tm_{fn.__name__}_shape", int(args[0].shape[0]))
                for k, (fn, args) in calls.items()},
            "ptxas": {k: cs.kernel_ptxas(k)
                      for k in ("general_verify", "sr_verify")}})
        rc |= not equal
    kernels.use_library(None)
    return rc


def k7_child(field: str) -> int:
    """K7 on the kernels check's arena and on the speculation arena."""
    import torch

    import tendermint_tpu_torch
    from tendermint_tpu_torch.crypto.cuda import kernels, resident

    if kernels.FIELD != field:
        raise AssertionError(f"the {field} child runs the {kernels.FIELD} field")
    dev = torch.device("cuda")
    kernels.build()
    checks, digests = {}, {}
    cs.arena_check(1024, dev, checks, digests)
    vs, commit, bid, _seeds = cs.make_commit(cs.N_VALIDATORS)
    rc = 0
    for name, arena in (("check", cs.KEEP["arena"]),
                        ("spec", cs.spec_arena(vs, commit, bid, dev))):
        largs = arena.launch_args()
        v_k = resident.arena_verify(*largs)
        equal = bool(torch.equal(v_k, resident.arena_verify_plain(*largs)))
        if name == "check":
            equal &= all(checks["arena_verify"].values())
        else:
            equal &= bool(v_k[largs[3]].all())
        shape = (kernels.launch_shapes("tm_arena_verify_shape", arena.capacity)
                 if "tm_arena_verify_shape" in kernels._SIGNATURES else None)
        cs.emit({"kernel": "arena_verify", "arena": name,
                 "package": os.path.dirname(tendermint_tpu_torch.__file__),
                 "lanes": arena.capacity, "active_lanes": arena.active_lanes,
                 "verdicts_equal_plain": equal, "digest": cs.digest(v_k),
                 "ms": cs.cuda_ms(lambda: resident.arena_verify(*largs), 10),
                 "launch": shape, "ptxas": cs.kernel_ptxas("arena_verify")})
        rc |= not equal
    return rc


def main() -> int:
    import torch

    tree = (["--tree", os.path.abspath(sys.argv[sys.argv.index("--tree") + 1])]
            if "--tree" in sys.argv else [])
    if "--field" in sys.argv:
        if tree:
            sys.path.insert(0, tree[1])
        return child(sys.argv[sys.argv.index("--field") + 1], sys.argv[1:])
    families = ([a for a in sys.argv[1:] if a in FAMILIES]
                or list(DEFAULT_FAMILIES))
    if not torch.cuda.is_available():
        print("sweep_warps: no CUDA device", file=sys.stderr)
        return 2
    rc = 0
    for field in CANDIDATES:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *families,
             "--field", field, *tree],
            stdout=subprocess.PIPE, text=True,
            env=dict(os.environ, TM_TPU_FIELD=field))
        timer = threading.Timer(CHILD_TIMEOUT_S, proc.kill)
        timer.start()
        try:
            for line in proc.stdout:
                cs.emit({"field": field, **json.loads(line)})
            rc |= proc.wait() != 0
        finally:
            timer.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(cs.nvidia_smi(), flush=True)
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
