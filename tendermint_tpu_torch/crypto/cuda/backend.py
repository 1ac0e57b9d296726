"""One backend-classification vocabulary for the port (reference:
tendermint_tpu/crypto/tpu/backend.py).

The launch ledger stamps each record with the backend its verdicts
landed on, the watchdog classifies the effective backend from those
stamps, and a benchmark stamps its lines with the same word. Pure
string logic: no torch, importable anywhere.

Vocabulary:
  * ``backend_label(device)`` — the stamp a ledger record or a
    benchmark line carries: ``"gpu"`` for a CUDA device string
    (``cuda``, ``cuda:0``) or a card's name (``NVIDIA H100 80GB
    HBM3``), ``"cpu-fallback"`` for anything else (hyphen, the
    reference's spelling). The reference answers ``"tpu"`` only for a
    string that holds "tpu", so it would stamp a card ``cpu-fallback``.
  * ``classify_stamps(...)`` — ``"silicon"`` / ``"cpu_fallback"`` plus
    the misrepresentation and unattribution problems; ``"gpu"`` and
    ``"cuda"`` are silicon stamps beside the reference's.
  * ``EFFECTIVE_STATES`` — the watchdog's closed state set.
"""

from __future__ import annotations

# Substrings that mark a device string as CPU execution.
CPU_DEVICE_MARKERS = ("cpu", "host")
# Backend stamps that claim accelerator silicon.
SILICON_BACKENDS = ("gpu", "cuda", "tpu", "silicon", "device")
# Substrings of a device string or a card's name that name a GPU.
GPU_DEVICE_MARKERS = ("cuda", "gpu", "nvidia", "h100", "hopper")

# The watchdog's effective-backend classification (closed set; the
# tpu_effective_backend gauge is one-hot over exactly these):
#   gpu           — a successful launch landed on the card within the
#                   window
#   mesh_degraded — launches complete, but one or more mesh entries are
#                   breaker-evicted: the fabric serves on the survivors
#   cpu_fallback  — launches complete on the CPU (or raise and degrade
#                   to the host) with no card success in the window
#   idle          — records exist, but none within the window
#   unknown       — no launch has ever been recorded
EFFECTIVE_STATES = ("gpu", "mesh_degraded", "cpu_fallback", "idle",
                    "unknown")


def device_is_cpu(device: str) -> bool:
    d = str(device).lower()
    return any(m in d for m in CPU_DEVICE_MARKERS)


def backend_label(device: str) -> str:
    """Device string or card name -> the stamp a record carries ("gpu"
    or "cpu-fallback")."""
    d = str(device).lower()
    if device_is_cpu(d):
        return "cpu-fallback"
    return "gpu" if any(m in d for m in GPU_DEVICE_MARKERS) \
        else "cpu-fallback"


def effective_state_of(device: str) -> str:
    """Device string of a completed launch -> the watchdog state it
    evidences ("gpu" or "cpu_fallback")."""
    return "gpu" if backend_label(device) == "gpu" else "cpu_fallback"


def classify_stamps(backend_stamp: str, cpu_fallback: bool,
                    device: str) -> tuple[str, list[str]]:
    """A measured value's explicit stamps -> (``"silicon"`` |
    ``"cpu_fallback"``, problems). A silicon backend stamp contradicted
    by the fallback flag or a CPU device string is ``misrepresented``;
    a value with no stamps at all is ``unattributed``."""
    problems: list[str] = []
    stamp = str(backend_stamp or "").lower()
    device = str(device or "")
    if stamp:
        claims_silicon = any(b in stamp for b in SILICON_BACKENDS) \
            and "cpu" not in stamp
        if claims_silicon and (cpu_fallback or device_is_cpu(device)):
            problems.append(
                f"misrepresented: backend stamp {stamp!r} but "
                f"cpu_fallback={cpu_fallback} device={device!r}")
            return "cpu_fallback", problems
        return ("silicon" if claims_silicon else "cpu_fallback"), problems
    if cpu_fallback or (device and device_is_cpu(device)):
        return "cpu_fallback", problems
    if device:
        return "silicon", problems
    problems.append(
        "unattributed: measured value with no device/backend stamp")
    return "cpu_fallback", problems
