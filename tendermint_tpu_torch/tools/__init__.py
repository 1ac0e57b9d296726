"""Operator tools (reference: tendermint_tpu/tools/ and the repository's
root tools/): height forensics (in a process, and over a fleet's debug
servers with height_forensics), the scenario sweep, the remote-signer
conformance harness, the crash-point sweep, the soak, and the lints
that hold the port's span, ledger, metric, failpoint, scenario and
crash-recovery catalogs to their call sites, docs and tests. Each runs
as ``python -m tendermint_tpu_torch.tools.<name>``."""
