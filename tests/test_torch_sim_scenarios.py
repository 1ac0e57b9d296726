"""Each smoke-tier scenario of the simulator's catalog, in the port
(tendermint_tpu_torch/sim) and in the JAX package (tendermint_tpu/sim),
on the host route, at the seeds tests/test_sim.py runs it (seed 3 for
timestamp_skew, withhold_parts and double_propose, which the reference
runs only in its slow tier: each is a 4-node run of a few seconds).

The reports must be equal on chain, app_hashes, final_heights,
fault_log, restarts, evidence_committed and heights_at_heal, with no
violation in either; statesync_poison's restore record too, and
mesh_device_loss's eviction record with the mesh entries mapped by
index (the reference's eight XLA CPU devices, the port's
``set_mesh(["cpu"] * 8)``). Both packages draw the gossip picks from
the seed the port's run_scenario uses (tests/test_torch_sim.py `run`).
Tolerance: exact. The traffic counts (report["net"]) are not compared:
the port's nodes send a few frames more or fewer while they stop after
the run's last virtual second, every frame before it equal (smoke_quorum
at seed 1: 6,047 frames against 6,045), since the port's
ConsensusState.on_stop awaits its vote scheduler's cancellation.

Each reference run goes to a worker process (spawned once for the file)
while the port's runs here, so a case takes the longer of the two."""

import multiprocessing

import pytest

from tendermint_tpu_torch import device
from tendermint_tpu_torch.crypto import batch as port_batch
from tendermint_tpu_torch.crypto.cuda import verify as port_verify

from test_torch_sim import PORT_MESH, REPORT_KEYS, _cpu, run, sim  # noqa: F401


SMOKE_CASES = [
    ("smoke_quorum", 1), ("smoke_partition", 3), ("smoke_churn", 3),
    ("smoke_equivocation", 3), ("smoke_garbage_flood", 3),
    ("trust_collapse", 5), ("timestamp_skew", 3), ("withhold_parts", 3),
    ("double_propose", 3), ("statesync_poison", 1), ("statesync_poison", 2),
    ("mesh_device_loss", 1), ("mesh_device_loss", 2),
]


# the byzantine kinds each case's net carries (the catalog's rule: every
# kind reaches a named scenario and a test of the port)
KINDS = {"smoke_equivocation": {"equivocation"},
         "smoke_garbage_flood": {"garbage_flood"},
         "trust_collapse": {"bad_signature_flood"},
         "timestamp_skew": {"timestamp_skew"},
         "withhold_parts": {"withhold_parts"},
         "double_propose": {"double_propose"},
         "statesync_poison": {"snapshot_poison", "snapshot_liar"}}


def reference_run(name: str, seed: int):
    """The reference's report of (name, seed), with the entry names of
    its mesh: its JAX CPU devices, which it names once JAX is up (the
    tests' conftest imports it; so does this worker)."""
    import jax  # noqa: F401

    from tendermint_tpu.crypto import batch

    report = run("tendermint_tpu", name, seed)
    batch.reset_breakers()
    return report, batch._mesh_device_strs()


@pytest.fixture(scope="module")
def reference_worker():
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        yield pool


def test_every_smoke_scenario_is_a_case():
    names = {n for n, f in sim("tendermint_tpu_torch",
                               "scenario").SCENARIOS.items()
             if f().tier == "smoke"}
    assert names == {n for n, _ in SMOKE_CASES} and len(names) == 11


@pytest.mark.parametrize("name,seed", SMOKE_CASES,
                         ids=[f"{n}-{s}" for n, s in SMOKE_CASES])
def test_smoke_scenario_reports_equal_the_reference(name, seed,
                                                    reference_worker):
    mesh = name == "mesh_device_loss"
    if mesh:
        device.set_mesh(PORT_MESH)
    specs = sim("tendermint_tpu_torch", "scenario").SCENARIOS[name]()
    assert {s["kind"] for _, s in specs.byzantine_specs()} == \
        KINDS.get(name, set())
    pending = reference_worker.apply_async(reference_run, (name, seed))
    port = run("tendermint_tpu_torch", name, seed)
    ref, ref_names = pending.get(timeout=600)
    assert ref["violations"] == [] and port["violations"] == []
    assert {k: port[k] for k in REPORT_KEYS} == \
        {k: ref[k] for k in REPORT_KEYS}
    assert len(set(port["app_hashes"])) > 2
    if name == "statesync_poison":
        assert port["statesync"] == ref["statesync"]
        assert port["statesync"]["restore_attempts"] >= 2
    if mesh:
        port_names = list(port_verify._mesh().names)
        assert len(ref_names) == len(port_names) == 8
        to_port = dict(zip(ref_names, port_names))
        assert port["mesh_device"] == to_port[ref["mesh_device"]] == \
            port_names[3]
        assert port["mesh_evicted"] == [to_port[d]
                                        for d in ref["mesh_evicted"]]
        assert port["mesh_readmitted"] == [to_port[d]
                                           for d in ref["mesh_readmitted"]]
        assert port["mesh_device"] in port["mesh_evicted"]
        assert port["mesh_device"] not in port["mesh_readmitted"]
        assert port_batch.breaker("ed25519").state == port_batch.CLOSED
