"""Build and load the port's CUDA kernels.

The sources in ``tendermint_tpu_torch/csrc`` are compiled by hand with
``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds rather than minutes). The build runs at first use, into
``build/torch_kernels/<field>-<hash>/`` beside the package, one
``nvcc -c`` per kernel source started together, then one link. The
field is the one crypto/cuda/fieldsel.py selected: ``i32``, or ``f32``
(every source compiled with ``-DTM_FIELD_F32``, so the field-bearing
kernels take csrc/field_f32.cuh); the hash covers the sources, the
target and the field, so the two builds never share a directory.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` classifies a non-zero code. A fault
inside a running kernel surfaces later, at a synchronisation:
``sync`` (``tm_sync``, cudaStreamSynchronize) runs before every
readback of a kernel's result (``readback``) and classifies the code
it returns the same way (``error``): by the code, not by where it was
seen.

Nothing here runs at import: the CPU tests import every module, and
the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .fieldsel import CHOICE as FIELD

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("build_tables.cu", "xverify.cu", "general_verify.cu", "splice.cu",
           "arena_verify.cu", "sr_verify.cu")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FIELD_FLAGS = {"i32": [], "f32": ["-DTM_FIELD_F32"]}[FIELD]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures (pointers and the stream as void*, sizes as int).
_SIGNATURES = {
    "tm_build_tables": (_P, _P, _P, _I, _P),
    "tm_xverify": (_P,) * 17 + (_I, _I, _P, _P),
    "tm_general_verify": (_P, _P, _P, _I, _P, _P, _P, _I, _P, _P),
    "tm_splice": (_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P),
    "tm_clear": (_P, _I, _I, _P),
    "tm_arena_verify": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _P, _P),
    "tm_sr_verify": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P),
    "tm_sync": (_P,),
    "tm_build_tables_shape": (_I, _P),
    "tm_xverify_shape": (_I, _I, _P),
    "tm_general_verify_shape": (_I, _P),
    "tm_sr_verify_shape": (_I, _P),
    "tm_arena_verify_shape": (_I, _P),
}
# What a *_shape export reports for each launch (csrc/common.cuh
# tm_shape): the grid, the block, the dynamic shared bytes, the blocks
# cudaOccupancyMaxActiveBlocksPerMultiprocessor keeps resident on an
# SM, and cudaFuncGetAttributes' registers, local (stack) bytes and
# static shared bytes.
SHAPE_KEYS = ("blocks", "threads", "dynamic_shared_bytes", "blocks_per_sm",
              "registers", "stack_bytes", "static_shared_bytes")

# CUDA runtime error codes (enum cudaError of the CUDA headers), by what
# they say. A fault inside one of the port's kernels raises
# KernelError, which no breaker catches (crypto/batch.py UNCAUGHT):
KERNEL_FAULTS = {
    700: "cudaErrorIllegalAddress",      # out-of-bounds load or store
    710: "cudaErrorAssert",              # device-side assert or trap
    714: "cudaErrorHardwareStackError",  # stack overflow or corruption
    715: "cudaErrorIllegalInstruction",
    716: "cudaErrorMisalignedAddress",
    718: "cudaErrorInvalidPc",
    719: "cudaErrorLaunchFailure",       # any other fault in a kernel
}
# The device's health, not the port's code: an ordinary RuntimeError,
# which the breakers catch and degrade around.
DEVICE_HEALTH = {
    46: "cudaErrorDevicesUnavailable",
    100: "cudaErrorNoDevice",
    214: "cudaErrorECCUncorrectable",
    702: "cudaErrorLaunchTimeout",       # a kernel outran the watchdog
}
# Any other code is the port's fault too (a launch refused for its
# configuration or arguments, say) and raises KernelError.

# Filled by the build: wall seconds and each source's ptxas report.
BUILD_INFO: dict = {}

_LOCK = threading.Lock()
_LIB = None


class KernelError(RuntimeError):
    """A kernel failed to build, to launch or to run (a CUDA code that
    is not in DEVICE_HEALTH), or was handed a tensor it does not take.
    No breaker catches it (crypto/batch.py UNCAUGHT): it is a fault of
    the port, not a device to degrade around, and it propagates to the
    caller of the entry point."""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")


def _digest(flags: tuple) -> str:
    h = hashlib.sha256(" ".join([ARCH, *flags]).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(defines: tuple = ()) -> Path:
    """Compile every source in parallel and link the library; returns
    its path. Reuses a library already built from identical sources.
    `defines` ("NAME=VALUE", ...) are extra -D flags, for a build that
    overrides a compile-time launch shape (sweep_warps.py); the
    library lib() loads takes none."""
    flags = (*FIELD_FLAGS, *(f"-D{d}" for d in defines))
    out_dir = BUILD_ROOT / f"{FIELD}-{_digest(flags)}"
    lib_path = out_dir / "libtm_kernels.so"
    if lib_path.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("cached", True)
        log = out_dir / "ptxas.log"
        if "ptxas" not in BUILD_INFO and log.exists():
            BUILD_INFO["ptxas"] = dict(
                part.split("\n", 1) for part in
                log.read_text().split("== ")[1:])
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in SOURCES:
        obj = out_dir / (src[:-3] + ".o")
        cmd = [nvcc, ARCH, *flags, "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-c", str(CSRC / src), "-o",
               str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    ptxas, objs, failed = {}, [], []
    for src, obj, proc in procs:
        log, _ = proc.communicate()
        ptxas[src] = log
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
    if failed:
        raise KernelError("nvcc failed:\n" + "\n".join(failed))
    tmp = out_dir / f"libtm_kernels.{os.getpid()}.so"
    link = subprocess.run([nvcc, ARCH, "-shared", "-o", str(tmp), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise KernelError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)  # atomic: concurrent builders agree
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False,
                      ptxas=ptxas)
    (out_dir / "ptxas.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in ptxas.items()))
    return lib_path


def load(path: Path) -> ctypes.CDLL:
    """The library at `path` with its C signatures set."""
    handle = ctypes.CDLL(str(path))
    for name, args in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    handle.tm_error_string.argtypes = [ctypes.c_int]
    handle.tm_error_string.restype = ctypes.c_char_p
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = load(build())
        return _LIB


def use_library(path: Path | None) -> None:
    """Make lib() return the library at `path` (a build with defines),
    or, for None, the default build again."""
    global _LIB
    with _LOCK:
        _LIB = None if path is None else load(path)


def launch_shapes(export: str, *args, launches: int = 1) -> list[dict]:
    """The shape of each launch a kernel makes, from its *_shape export
    (``tm_build_tables_shape`` nkeys: K1's two launches;
    ``tm_xverify_shape`` n, structured (K3's and K5's);
    ``tm_general_verify_shape`` n; ``tm_sr_verify_shape`` n;
    ``tm_arena_verify_shape`` n),
    on the current CUDA device: SHAPE_KEYS and the resident warps an
    SM."""
    buf = (ctypes.c_int * (len(SHAPE_KEYS) * launches))()
    check(getattr(lib(), export)(*args, buf), export)
    out = []
    for k in range(launches):
        d = dict(zip(SHAPE_KEYS, buf[k * len(SHAPE_KEYS):
                                     (k + 1) * len(SHAPE_KEYS)]))
        d["warps_per_sm"] = d["blocks_per_sm"] * d["threads"] // 32
        out.append(d)
    return out


def error(rc: int, what: str) -> RuntimeError:
    """The exception for CUDA error code rc: a plain RuntimeError for a
    DEVICE_HEALTH code, else KernelError."""
    name = (KERNEL_FAULTS.get(rc) or DEVICE_HEALTH.get(rc)
            or lib().tm_error_string(rc).decode())
    msg = f"{what}: CUDA error {rc} ({name})"
    return RuntimeError(msg) if rc in DEVICE_HEALTH else KernelError(msg)


def check(rc: int, name: str) -> None:
    """Raise for the code an entry point returned after its launch."""
    if rc != 0:
        raise error(rc, f"{name} launch failed")


def _stream_sync(device, stream) -> int:
    """cudaStreamSynchronize's code for `stream` (default: the device's
    current stream); 0 for a CPU device, which runs plain versions."""
    if device.type != "cuda":
        return 0
    ptr = stream.cuda_stream if stream is not None else stream_ptr(device)
    return lib().tm_sync(ptr)


def sync(device, stream=None) -> None:
    """Wait for the kernels queued on `stream` and raise, classified by
    ``error``, a CUDA error it reports: a fault inside a kernel shows
    here, before a readback would raise it as torch's RuntimeError."""
    rc = _stream_sync(device, stream)
    if rc != 0:
        raise error(rc, f"kernel on {device}")


def readback(t):
    """A kernel's result on the host, as numpy, after ``sync``."""
    sync(t.device)
    return t.cpu().numpy()


def require(t, name: str, dtype, shape: tuple, device) -> None:
    """Wrapper-side argument check: a kernel takes contiguous tensors
    of one dtype and shape on the launch device, nothing else."""
    if t.device != device:
        raise KernelError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise KernelError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise KernelError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise KernelError(f"{name}: not contiguous")


def require_aligned(t, name: str, align: int) -> None:
    """Wrapper-side base-alignment check, for a kernel that reads or
    writes t in aligned words: KernelError unless t's data starts on an
    `align`-byte boundary."""
    if t.data_ptr() % align:
        raise KernelError(
            f"{name}: base {t.data_ptr():#x} not {align}-byte aligned")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
