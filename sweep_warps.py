#!/usr/bin/env python3
"""Time K3/K5 and K4/K9 at each candidate launch shape, to choose
TM_XV_WARPS, TM_X4_LANES and TM_X4_WARPS; time K7 in both fields, and
K6/K8's splice and clear.

    python3 sweep_warps.py [xv | x4 | k7 | k6 | commit] [--tree DIR]
                           [--warps W]

With no argument the xv and x4 families are swept; `xv` sweeps K3 and
K5 only, `x4` K4 and K9 only, `k7` times K7 alone, `k6` K6 and K8's
splice and clear alone. `--warps W` sweeps only TM_XV_WARPS = W.

Every kernel time is given twice: its device time a call (`*_device_ms`:
chip_smoke.device_ms, back-to-back calls captured in a CUDA graph and
its replay timed by CUDA events, no host gaps; measured ROUNDS times in
turns with the other kernels of the line) and the time a call through
its wrapper by CUDA events (`*_ms`: chip_smoke.cuda_ms, the host's work
between launches included).

TM_XV_WARPS (tendermint_tpu_torch/csrc/common.cuh) is the number of
warps a block of K3 and K5 (xverify.cu, one kernel) runs for its 32
lanes, a compile-time constant of each field's build. For each field
(a child process with TM_TPU_FIELD set, since the field is chosen at
import) this script builds the kernel library once for each candidate
count (kernels.build with -DTM_XV_WARPS=W: i32 4, 8 and 16; f32 4 and
8, since the f32 build's 255 registers a thread allow at most 256
threads a block) and, on chip_smoke.py's 10,240-validator commit:

- K1 once, with the default build: its tables against its plain
  version limb for limb, its CUDA-event time, and each of its two
  launches' device time by torch.profiler (the chain's, the rows');
- for each W: K3 on the whole commit on one card in the structured
  form (the sign bytes assembled inside the launch; on a checkout from
  before that, `--tree`, K2's launch and then K3's, as its structured
  route makes them), and K5 on the commit's four 2,560-key shards
  (3,072 lanes a shard, the structured form, the fabric phase's
  shapes), one shard on one stream and all four on four streams; every
  verdict against the plain version; the times, the launch shapes
  (resident warps an SM) and the ptxas lines.

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

`k6` times, in the i32 child, K6's splice of the last 1,024-row burst
into copies of the speculation arena's buffers (spec_arena: 12,288
lanes), K6's clear of its 12,288 lanes, and K8's splice and clear on a
MeshResidentArena of the same lanes over four logical shards of cuda:0
(chip_smoke.py's healing shapes), each against its plain version; and
the host milliseconds of the arenas' whole splice of that burst (pack,
upload, K6), median of 20.
`commit` times, in the i32 child, `ValidatorSet.verify_commit` on
chip_smoke.py's 10,240-validator commit with its tables built, host
milliseconds a call (median of COMMIT_RUNS after one warm call): on one
card, then on four logical shards of cuda:0 at the fabric phase's
crossover (one K5 launch a shard). Run with `--tree` on the parent in
the same call (parent, this tree, this tree, parent) it shows what a
change to the verify path's host side costs.

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
import statistics
import subprocess
import sys
import threading

import chip_smoke as cs

CANDIDATES = {"i32": (4, 8, 16), "f32": (4, 8)}
X4_CANDIDATES = {"i32": ((8, 4), (16, 6), (32, 7), (32, 8)),
                 "f32": ((8, 4), (16, 6), (32, 8))}
FAMILIES = ("xv", "x4", "k7", "k6", "commit")
DEFAULT_FAMILIES = ("xv", "x4")
CHILD_TIMEOUT_S = 600
ROUNDS = 5  # device-time measurements of each kernel, in turns
COMMIT_RUNS = 21  # verify_commit calls a placement (after a warm one)


def warps_to_sweep(field: str) -> tuple:
    """TM_XV_WARPS values to build: `--warps W` alone, else the field's
    CANDIDATES."""
    if "--warps" in sys.argv:
        return (int(sys.argv[sys.argv.index("--warps") + 1]),)
    return CANDIDATES[field]


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
    if "k6" in families and field == "i32":  # K6 and K8 have no field
        rc |= k6_child()
    if "commit" in families and field == "i32":
        rc |= commit_child()
    return rc


def commit_child() -> int:
    """verify_commit's host ms a call on the 10,240-validator commit, on
    one card and on four logical shards of it (see the docstring)."""
    import time

    import tendermint_tpu_torch
    from tendermint_tpu_torch import device as tdevice
    from tendermint_tpu_torch.crypto.cuda import expanded

    vs, commit, bid, _ = cs.make_commit(cs.N_VALIDATORS)

    def p50() -> float:
        vs.warm_device_tables().join()
        runs = []
        for _ in range(COMMIT_RUNS + 1):
            t0 = time.perf_counter()
            vs.verify_commit(cs.CHAIN, bid, commit.height, commit)
            runs.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(runs[1:])

    one_card = p50()
    expanded.set_shard_crossover(cs.FABRIC_CROSSOVER)
    tdevice.set_mesh(["cuda"] * cs.LOGICAL_SHARDS)
    sharded = p50()
    print(json.dumps({"family": "commit", "runs": COMMIT_RUNS,
                      "verify_commit_p50_ms": one_card,
                      "sharded_verify_commit_p50_ms": sharded,
                      "package": os.path.dirname(
                          tendermint_tpu_torch.__file__)}), flush=True)
    return 0


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
    tpl = (f["pre"], f["pre_len"], f["suf"], f["suf_len"])
    pat = (f["patch"], f["split"], f["patch_len"], f["group"])
    msg, nblocks = expanded.assemble_plain(*tpl, *pat, width)
    btab = verify._btab(dev)
    # k3: the structured route's launches; extra: K2 alone (a checkout
    # with K2's own launch) or K3's bytes form on the same lanes
    # (and the structured form through K5's wrapper on the one-card
    # tables: on a checkout with K2's own launch, K5's assembly by its
    # hashing warp alone)
    k5_one = (lambda: expanded.shard_verify(
        f["idx"], one.akeys, f["sb"], f["s_ok"], one.key_ok, one.tables, btab,
        templates=tpl, patches=pat, width=width))
    if hasattr(expanded, "assemble"):
        def k3():
            m, nb = expanded.assemble(*tpl, *pat, width)
            return expanded.xverify(f["idx"], one.akeys, f["sb"], m, nb,
                                    f["s_ok"], one.key_ok, one.tables, btab)
        extra = {"assemble": lambda: expanded.assemble(*tpl, *pat, width),
                 "xverify_structured_by_k5": k5_one}
    else:
        sargs = (f["idx"], one.akeys, f["sb"], f["s_ok"], one.key_ok,
                 one.tables, btab)

        def k3():
            return expanded.xverify(*sargs, templates=tpl, patches=pat,
                                    width=width)
        extra = {"xverify_bytes_form": lambda: expanded.xverify(
            *sargs, msg=msg, nblocks=nblocks),
            "xverify_structured_by_k5": k5_one}
    want3 = expanded.xverify_plain(f["idx"], one.akeys, f["sb"], msg, nblocks,
                                   f["s_ok"], one.key_ok, one.tables, btab)
    if not bool(want3[:len(keys)].all()):
        raise AssertionError("the plain K3 rejects the valid commit")
    set_mesh(["cuda:0"] * cs.LOGICAL_SHARDS)
    expanded.set_shard_crossover(cs.FABRIC_CROSSOVER)
    try:
        return _sweep(field, dev, keys, lanes, sigs, sbatch, k3, want3, extra)
    finally:
        expanded.set_shard_crossover(None)
        set_mesh(None)


def _sweep(field, dev, keys, lanes, sigs, sbatch, k3, want3, extra) -> int:
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

    # the export names and arguments of the checkout's K3 and K5 shapes
    # (one kernel since K2 runs inside K3; two before)
    legacy = "tm_shard_verify_shape" in kernels._SIGNATURES
    n3, n5 = int(want3.shape[0]), int(calls[0][0][0].shape[0])
    shapes = ((("tm_xverify_shape", n3), ("tm_shard_verify_shape", n5, 1))
              if legacy else (("tm_xverify_shape", n3, 1),
                              ("tm_xverify_shape", n5, 1)))
    sources = (("xverify.cu", "k_xverify"),
               ("shard_verify.cu" if legacy else "xverify.cu",
                "k_shard_verify" if legacy else "k_xverify"))
    rc = 0
    for w in warps_to_sweep(field):
        kernels.use_library(kernels.build(defines=(f"TM_XV_WARPS={w}",)))
        equal = bool(torch.equal(k3(), want3) and all(
            torch.equal(k5(d), want5[d]) for d in range(len(calls))))
        log = kernels.BUILD_INFO.get("ptxas", {})
        # device times in turns, ROUNDS times each, so that a drift of the
        # card's clock between two measurements moves them alike
        timed = dict(xverify=k3, **extra, shard_verify_one=lambda: k5(0))
        rounds = {k: [] for k in timed}
        for _ in range(ROUNDS):
            for k, fn in timed.items():
                rounds[k].append(cs.device_ms(fn, 10))
        cs.emit({
            "warps": w, "verdicts_equal_plain": equal,
            **{f"{k}_device_ms": statistics.median(v)
               for k, v in rounds.items()},
            "device_ms_rounds": rounds,
            **{f"{k}_ms": cs.cuda_ms(fn, 10) for k, fn in timed.items()},
            "xverify_lanes": n3, "xverify_launches_a_call": 2 if legacy else 1,
            "shard_verify_four_ms": cs.cuda_ms(lambda: verify.run_shards(
                exp.mesh, lambda d, _dev: k5(d)), 10),
            "shard_verify_lanes": n5,
            "launch": {name: kernels.launch_shapes(*args) for name, args in
                       zip(("xverify", "shard_verify"), shapes)},
            "ptxas": {name: cs.ptxas_summary(log.get(src, ""), fn)
                      for name, (src, fn) in
                      zip(("xverify", "shard_verify"), sources)}})
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


def k6_child() -> int:
    """K6 and K8's splice and clear at the main path's shapes, and the
    arenas' whole splice of a burst (host ms)."""
    import torch

    import tendermint_tpu_torch
    from tendermint_tpu_torch.config import SpeculationConfig
    from tendermint_tpu_torch.crypto.cuda import kernels, resident
    from tendermint_tpu_torch.device import set_mesh

    dev = torch.device("cuda")
    kernels.build()
    vs, commit, bid, _seeds = cs.make_commit(cs.N_VALIDATORS)
    n = len(vs.validators)
    b = dict(ts=[c.timestamp for c in commit.signatures],
             sigs=[c.signature for c in commit.signatures])
    keep = list(range(n - cs.SPEC_BURST, n))
    arena = cs.spec_arena(vs, commit, bid, dev)
    args = cs.splice_args(arena, b, keep)
    packed_np = arena.pack(*args)
    packed = torch.from_numpy(packed_np).to(dev)
    bufs = [t.clone() for t in arena.buffers()]
    plain = [t.clone() for t in arena.buffers()]
    resident.splice(*bufs, packed)
    resident.splice_plain(*plain, packed)
    act, act_p = arena._active.clone(), arena._active.clone()
    resident.clear(act)
    resident.clear_plain(act_p)
    equal = (all(torch.equal(x, y) for x, y in zip(bufs, plain))
             and torch.equal(act, act_p))
    out = {"kernel": "k6", "lanes": arena.capacity, "rows": len(keep),
           "package": os.path.dirname(tendermint_tpu_torch.__file__),
           "splice_device_ms": cs.device_ms(
               lambda: resident.splice(*bufs, packed), 100),
           "splice_ms": cs.cuda_ms(lambda: resident.splice(*bufs, packed), 100),
           "clear_device_ms": cs.device_ms(lambda: resident.clear(act), 100),
           "clear_ms": cs.cuda_ms(lambda: resident.clear(act), 100),
           # the arena's splice of the burst, whole and by step: pack,
           # upload (pinned staging where the arena has it, else
           # pageable), the wrapper's launch on rows already on the card
           "arena_splice_host_ms": cs.host_ms(lambda: arena.splice(*args)),
           "pack_host_ms": cs.host_ms(lambda: arena.pack(*args)),
           "pageable_upload_host_ms": cs.host_ms(
               lambda: torch.from_numpy(packed_np).to(dev)),
           "splice_wrapper_host_ms": cs.host_ms(
               lambda: resident.splice(*bufs, packed))}
    if hasattr(arena, "_splice"):
        out["staged_upload_host_ms"] = cs.host_ms(
            lambda: arena._splice._upload(packed_np))
    set_mesh(["cuda:0"] * cs.LOGICAL_SHARDS)
    try:
        marena = resident.MeshResidentArena(SpeculationConfig().arena_lanes)
        marena.install_keys([v.pub_key.bytes() for v in vs.validators])
        marena.set_template(1, arena.pre[1, :arena.pre_len[1]].tobytes(),
                            arena.suf[1, :arena.suf_len[1]].tobytes())
        margs = cs.splice_args(marena, b, keep)
        local, per_block = cs.shard_deltas(marena, *margs)
        blk = marena._blocks[0]
        mbufs = [blk["bufs"][k].clone() for k in resident._SPLICED]
        mpacked = torch.from_numpy(per_block[0]).to(dev)
        per = marena.shard_capacity
        view = [torch.stack([t[d * per:(d + 1) * per]
                             for d in range(marena.n_shards)]).clone()
                for t in mbufs]
        resident.mesh_splice(*mbufs, mpacked)
        resident.mesh_splice_plain(view, [torch.from_numpy(p).to(dev)
                                          for p in local])
        mact = blk["bufs"]["active"].clone()
        mact_p = mact.view(-1, per).clone()
        resident.mesh_clear(mact, per)
        resident.mesh_clear_plain(mact_p)
        equal = equal and all(
            torch.equal(x.reshape(v.shape), v) for x, v in zip(mbufs, view)
        ) and torch.equal(mact.view(-1, per), mact_p)
        out.update(
            mesh_lanes=int(mact.numel()), mesh_shards=marena.n_shards,
            mesh_splice_device_ms=cs.device_ms(
                lambda: resident.mesh_splice(*mbufs, mpacked), 100),
            mesh_splice_ms=cs.cuda_ms(
                lambda: resident.mesh_splice(*mbufs, mpacked), 100),
            mesh_clear_device_ms=cs.device_ms(
                lambda: resident.mesh_clear(mact, per), 100),
            mesh_clear_ms=cs.cuda_ms(lambda: resident.mesh_clear(mact, per),
                                     100),
            mesh_arena_splice_host_ms=cs.host_ms(
                lambda: marena.splice(*margs)))
    finally:
        set_mesh(None)
    out["equal_plain"] = bool(equal)
    cs.emit(out)
    return 0 if equal else 1


def main() -> int:
    import torch

    tree = (["--tree", os.path.abspath(sys.argv[sys.argv.index("--tree") + 1])]
            if "--tree" in sys.argv else [])
    warps = (["--warps", sys.argv[sys.argv.index("--warps") + 1]]
             if "--warps" in sys.argv else [])
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
             "--field", field, *tree, *warps],
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
