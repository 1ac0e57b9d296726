"""The port's native (C) host code, loaded with ctypes (reference:
tendermint_tpu/native/__init__.py).

``pack.c`` is built at first use with ``cc -O3 -shared -fPIC`` into
``build/native/<hash>/_pack.so`` beside the package (the hash covers
the source, so an edited source builds anew), renamed into place
atomically so that concurrent builders agree. Nothing here is
required: with no C compiler, or a build that fails, ``lib()`` is None
and the callers take their numpy paths, as in the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
from numpy.ctypeslib import ndpointer

logger = logging.getLogger("native")

SOURCE = Path(__file__).resolve().parent / "pack.c"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
_lib = None
_tried = False


def so_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / digest / "_pack.so"


def _build_so() -> Path | None:
    if not SOURCE.exists():
        return None
    so = so_path()
    if so.exists():
        return so
    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("clang")
    if cc is None:
        return None
    try:
        so.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
    except OSError as e:
        logger.warning("native build failed (%s); using numpy paths", e)
        return None
    try:
        subprocess.run([cc, "-O3", "-shared", "-fPIC", str(SOURCE), "-o",
                        tmp], check=True, capture_output=True, timeout=60)
        os.replace(tmp, so)  # atomic; concurrent builders all win
        return so
    except Exception as e:  # compiler missing/broken: numpy fallback
        logger.warning("native build failed (%s); using numpy paths", e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def lib():
    """The loaded native library, or None (fallback to numpy)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build_so()
    if so is None:
        return None
    try:
        L = ctypes.CDLL(str(so))
        L.tm_pack_pad.restype = None
        L.tm_pack_pad.argtypes = [
            ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # flat
            ndpointer(np.int64, flags="C_CONTIGUOUS"),   # starts
            ndpointer(np.int64, flags="C_CONTIGUOUS"),   # lens
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # out
            ndpointer(np.int64, flags="C_CONTIGUOUS"),   # nblocks
        ]
        _lib = L
    except OSError as e:  # pragma: no cover
        logger.warning("native load failed (%s); using numpy paths", e)
    return _lib
