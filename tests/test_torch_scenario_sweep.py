"""The port's scenario sweep (python -m
tendermint_tpu_torch.tools.scenario_sweep) against the reference's
root tools/scenario_sweep.py: the same --list, the same refusal of an
unknown scenario, and a --determinism run of (smoke_quorum, 1) that
exits 0 with one SWEEP line whose keys are the reference's and whose
values are the reference's but for the wall time (the reference's run
in this process, its gossip picks drawn from the seed the port's run
uses, reseeded for each run as the port's run_scenario does)."""

import json
import os
import random
import subprocess
import sys
import types

from tendermint_tpu.libs import bits as ref_bits
from tendermint_tpu.sim import scenario as ref_scenario
from tendermint_tpu_torch.sim.scenario import pick_seed
from tendermint_tpu_torch.tools import scenario_sweep
from tools import scenario_sweep as ref_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sweep_lines(out: str) -> list[dict]:
    return [json.loads(line[len("SWEEP "):]) for line in out.splitlines()
            if line.startswith("SWEEP ")]


def test_list_and_refusal_equal_the_references(capsys):
    assert scenario_sweep.main(["--list"]) == 0
    port = capsys.readouterr().out
    assert ref_sweep.main(["--list"]) == 0
    assert port == capsys.readouterr().out
    assert len(port.splitlines()) == 13 and "wan_50" in port
    assert scenario_sweep.main(["--scenario", "nope"]) == 2
    port = capsys.readouterr()
    assert ref_sweep.main(["--scenario", "nope"]) == 2
    assert port == capsys.readouterr()
    assert scenario_sweep.parse_seeds("0:3") == [0, 1, 2] == \
        ref_sweep.parse_seeds("0:3")
    assert scenario_sweep.parse_seeds("4,7") == [4, 7]


def test_a_determinism_run_gives_the_references_sweep_line(
        capsys, monkeypatch):
    argv = ["--scenario", "smoke_quorum", "--seed", "1", "--determinism"]
    proc = subprocess.run(
        [sys.executable, "-m", "tendermint_tpu_torch.tools.scenario_sweep",
         *argv], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    port = sweep_lines(proc.stdout)
    assert proc.stdout.splitlines()[-1] == "1 runs, 0 failed"

    orig = ref_scenario.run_scenario

    def seeded(sc, seed):
        monkeypatch.setattr(ref_bits, "secrets", types.SimpleNamespace(
            randbelow=random.Random(pick_seed(sc.name, seed)).randrange))
        return orig(sc, seed)

    monkeypatch.setattr(ref_scenario, "run_scenario", seeded)
    monkeypatch.setattr(sys.modules["tendermint_tpu.sim"], "run_scenario",
                        seeded)
    assert ref_sweep.main(argv) == 0
    ref = sweep_lines(capsys.readouterr().out)
    assert len(port) == len(ref) == 1
    assert sorted(port[0]) == sorted(ref[0]) == sorted(
        ["scenario", "seed", "ok", "heights", "virtual_s", "wall_s",
         "evidence", "violations"])
    for line in port + ref:
        line.pop("wall_s")
    assert port == ref
    assert port[0]["ok"] is True and port[0]["heights"] >= 4
