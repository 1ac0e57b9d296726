"""Operator tools (reference: tendermint_tpu/tools/ and the repository's
root tools/): height forensics, the scenario sweep and the lints that
hold the port's span, ledger, metric, failpoint and scenario catalogs
to their call sites, docs and tests. Each lint runs as
``python -m tendermint_tpu_torch.tools.<name>``."""
