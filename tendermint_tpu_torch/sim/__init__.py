"""Deterministic large-net simulation, the scenario factory (reference:
tendermint_tpu/sim/).

Layers a virtual clock, a seeded network model and a byzantine
validator catalog over the ordinary node assembly so 50–100-node
nets with partitions, churn and byzantine committee members run in
VIRTUAL time — hundreds of seeded scenarios per CI shard instead of
a handful of wall-clock nets per hour — and every failure reproduces
from its ``(scenario, seed)`` pair alone.

Modules:

  clock.py     VirtualClock + the sim event loop (timers advance
               simulated time; executors run inline for determinism)
  network.py   seeded per-link latency/jitter/loss model, scheduled
               partitions/heals, in-memory frame delivery
  transport.py SimTransport/SimConn — the p2p Transport surface over
               the network model (no sockets, no crypto handshake)
  harness.py   SimNode (full node: stores + app + consensus/
               blockchain/evidence reactors over a real Switch),
               restartable for churn; deterministic genesis
  byzantine.py the byzantine validator catalog (equivocation,
               withheld parts, garbage/bad-signature floods,
               timestamp skew) driven through switch/consensus seams
               and surfaced to honest peers via behaviour.py conduct
  scenario.py  declarative Scenario spec + run_scenario(spec, seed)
               + the invariant suite (agreement, app-hash oracle,
               liveness-after-heal, bounded queues) + named SCENARIOS

Entry points: ``python -m tendermint_tpu_torch.tools.scenario_sweep``
(CLI), tests/test_torch_sim.py.
"""

from .scenario import SCENARIOS, Scenario, run_scenario  # noqa: F401
