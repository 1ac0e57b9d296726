"""Field-representation selector for the port's kernels and their plain
versions (the counterpart of tendermint_tpu/crypto/tpu/fieldsel.py).

Two implementations of GF(2^255-19), each a CUDA header and its plain
PyTorch version:

  * ``field`` — ten signed limbs in radix 2^25.5, int32 in the kernels
    (int64 products). DEFAULT.
  * ``field_f32`` — 32 signed 8-bit limbs in float32, every value an
    integer below 2^24, so exact (``TM_TPU_FIELD=f32``).

Both give the same verdicts lane for lane; the choice changes the
arithmetic, the table layout (crypto/cuda/expanded.py) and the kernel
library (crypto/cuda/kernels.py builds each field into its own
directory). The node reads the same variable as the reference, once, at
import: one setting drives a node whichever package it runs, and a bad
value raises ValueError at the import of the first module that needs
the field, with the reference's text.
"""

from __future__ import annotations

import os

CHOICE = os.environ.get("TM_TPU_FIELD", "i32")
if CHOICE not in ("i32", "f32"):  # a typo must not silently run the other
    raise ValueError(f"TM_TPU_FIELD={CHOICE!r}: expected 'i32' or 'f32'")


def __getattr__(name: str):
    """``F``, the chosen field module, loads on first use: it imports
    torch, which a caller that needs only CHOICE (kernels.py, and so the
    command line's key and home commands) must not pay for."""
    if name != "F":
        raise AttributeError(name)
    if CHOICE == "f32":
        from . import field_f32 as F
    else:
        from . import field as F
    globals()["F"] = F
    return F
