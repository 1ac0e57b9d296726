"""Evidence verification (reference capability: evidence/): the
duplicate-vote and light-client-attack checks against committed state
and the block store (verify.py). The pool, the reactor and the ABCI
form come with later slices of the port."""
