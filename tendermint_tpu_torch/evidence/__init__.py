"""Evidence verification (reference capability: evidence/): the
duplicate-vote check. The pool, the reactor and the checks against
committed state come with later slices of the port."""
