"""Manifest-driven end-to-end testnet runner with perturbations
(reference: tendermint_tpu/e2e/; Go test/e2e/runner/ —
setup/start/load/perturb/test/cleanup, perturb.go:12-60; manifest
schema test/e2e/pkg/manifest.go).

Where the Go reference drives docker-compose containers, this runner
drives real node SUBPROCESSES (`python -m tendermint_tpu_torch.cmd
start --device D`) on localhost — same process-level fault model
(SIGKILL, SIGSTOP, restart) without a container runtime. Every child
runs on the runner's device: the card unless `--device cpu`."""

from .manifest import Manifest, Perturbation  # noqa: F401
from .runner import Runner  # noqa: F401
