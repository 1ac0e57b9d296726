"""tendermint_tpu_torch — the PyTorch/CUDA port of tendermint_tpu.

The ported paths. Commit verification: a
``ValidatorSet.verify_commit*`` call over an ed25519 validator set is
verified on an NVIDIA GPU by four hand-written CUDA kernels (K1–K4).
Verify-ahead speculation: ``consensus.SpeculationPlane`` verifies
precommits as they arrive in a resident arena on the GPU (K6 splice and
clear, K7 arena verify) and serves the commit from those verdicts.
On a mesh of devices (``device.set_mesh``) the comb tables split by
key range (K5), the arena splits into shards with a sentinel each (K8),
and per-entry breakers (``crypto.batch``) evict a failing entry and
reshard over the survivors.
Wrappers are in ``crypto/cuda/``, sources in ``csrc/``. The JAX package
``tendermint_tpu`` is the reference it is held against; nothing here
imports it or JAX.

Device work runs on CUDA unless ``device.set_default_device("cpu")``
was called, in which case every kernel wrapper takes its plain PyTorch
version (the CPU tests do this).
"""
