"""Silicon watchdog: the *effective* verify backend, from evidence
(reference: tendermint_tpu/crypto/tpu/watchdog.py).

The configured backend (`[crypto] backend`) says what the operator
believes; the launch ledger says what happened. This module classifies
the effective backend from recent ledger records, so that verify paths
landing on the CPU become a named /status condition within ONE launch.

Classification (backend.EFFECTIVE_STATES):

    gpu           a successful launch landed on the card inside the
                  window
    mesh_degraded launches complete while mesh entries are evicted
    cpu_fallback  launches complete on the CPU, or raise and degrade to
                  the host, with no card success inside the window
    idle          records exist, but none inside the window
    unknown       no launch has ever been recorded

With `crypto.backend = "gpu"` (or the reference's "tpu", read as the
same promise) the device check degrades when any of these hold:

  * the effective backend is cpu_fallback or mesh_degraded;
  * records exist but no launch completed within the window
    (`crypto.watchdog_window_s`);
  * the exec p50 over the window's card launches drifts more than
    DRIFT_FACTOR x past the baseline. The port keeps no recorded
    baseline (the reference's docs/measured_silicon.json holds another
    chip's figures): its baseline comes only from
    TM_TPU_SILICON_BASELINE_MS, and without it there is no drift check,
    as in the reference when its file is missing;
  * a card's registered resident bytes exceed its memory
    (torch.cuda.get_device_properties(d).total_memory; the CPU tests
    pass a budget).

One successful card launch flips the verdict back to ok. With backend
"auto" (default) or "cpu" the watchdog reports but never degrades.

Pure module: the /status path never initialises CUDA itself.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from . import backend as _backend
from . import ledger as _ledger

DRIFT_FACTOR = 3.0
DEFAULT_WINDOW_S = 60.0
# The backends that promise the accelerator: the port's word and the
# reference's, so a config file loads in either package.
PROMISED = ("gpu", "tpu")

_LOCK = threading.Lock()
_CONFIGURED = "auto"
_WINDOW_S = DEFAULT_WINDOW_S

# Zero-arg callable returning the currently breaker-evicted mesh entry
# names (a pure read). crypto/batch.py registers it at import.
_EVICTED_SUPPLIER = None


def register_evicted_supplier(fn) -> None:
    global _EVICTED_SUPPLIER
    _EVICTED_SUPPLIER = fn


def evicted_mesh_devices() -> list[str]:
    """Mesh entries currently evicted by per-entry breakers ([] when no
    supplier is registered or the read fails)."""
    if _EVICTED_SUPPLIER is None:
        return []
    try:
        return sorted(_EVICTED_SUPPLIER())
    except Exception:  # pragma: no cover - status read never fatal
        return []


def configure(backend: str = "auto",
              window_s: float = DEFAULT_WINDOW_S) -> None:
    """The node pushes its [crypto] section here."""
    global _CONFIGURED, _WINDOW_S
    with _LOCK:
        _CONFIGURED = str(backend or "auto")
        _WINDOW_S = float(window_s) if window_s and window_s > 0 \
            else DEFAULT_WINDOW_S


def configured_backend() -> str:
    return _CONFIGURED


def window_s() -> float:
    return _WINDOW_S


def silicon_baseline_ms() -> float | None:
    """Device exec ms a launch the drift check compares against:
    TM_TPU_SILICON_BASELINE_MS, else None (no drift check)."""
    env = os.environ.get("TM_TPU_SILICON_BASELINE_MS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return None


_SUCCESS_VERDICTS = ("ok", "invalid")  # the launch itself completed


def classify(records: list[dict] | None = None) -> dict:
    """Effective-backend classification over the ledger (or an explicit
    record list, newest last). Updates the one-hot
    tpu_effective_backend gauge."""
    win = _WINDOW_S
    all_recs = _ledger.snapshot() if records is None else list(records)
    now = time.monotonic()
    recent = [r for r in all_recs if now - r["mono"] <= win]
    succ = [r for r in recent if r["verdict"] in _SUCCESS_VERDICTS]
    silicon = [r for r in succ
               if _backend.effective_state_of(r["device"]) == "gpu"]

    if not all_recs:
        state = "unknown"
    elif not recent:
        state = "idle"
    elif silicon:
        state = "gpu"
    else:
        state = "cpu_fallback"
    evicted = evicted_mesh_devices()
    if evicted and succ and state in ("gpu", "cpu_fallback"):
        state = "mesh_degraded"

    last_ok = max((r["mono"] for r in succ), default=None)
    last_any = max((r["mono"] for r in all_recs), default=None)
    exec_ms = [r["stages_ms"]["exec"] for r in (silicon or succ)
               if r.get("stages_ms", {}).get("exec") is not None]
    out = {
        "effective_backend": state,
        "configured_backend": _CONFIGURED,
        "evicted_devices": evicted,
        "window_s": win,
        "launches_in_window": len(recent),
        "last_device_launch_age_s": (
            round(now - last_ok, 3) if last_ok is not None else None),
        "last_record_age_s": (
            round(now - last_any, 3) if last_any is not None else None),
        "exec_p50_ms": _ledger._pctl(exec_ms, 0.5) if exec_ms else None,
    }
    _set_gauge(state)
    return out


def _set_gauge(state: str) -> None:
    try:
        from ...libs.metrics import tpu_metrics

        g = tpu_metrics().effective_backend
        for s in _backend.EFFECTIVE_STATES:
            g.set(1 if s == state else 0, backend=s)
    except Exception:  # pragma: no cover - metrics never fatal
        pass


def device_budgets() -> dict[str, int]:
    """{"cuda:<i>": total memory} of every card, when torch has already
    initialised CUDA in this process; {} otherwise."""
    torch = sys.modules.get("torch")
    try:
        if torch is None or not torch.cuda.is_initialized():
            return {}
        return {f"cuda:{i}": int(torch.cuda.get_device_properties(i)
                                 .total_memory)
                for i in range(torch.cuda.device_count())}
    except Exception:  # pragma: no cover - status read never fatal
        return {}


def hbm_check(budget_bytes: int | None = None) -> dict:
    """Registered resident bytes per device against its budget:
    `budget_bytes` for every device when given, else each card's own
    memory (a device with no known budget is never over). Over-budget
    devices are named."""
    totals = _ledger.hbm_device_totals()
    budgets = device_budgets() if budget_bytes is None else {}

    def budget(dev):
        if budget_bytes is not None:
            return budget_bytes
        if dev in budgets:
            return budgets[dev]
        if dev == "cuda" and "cuda:0" in budgets:
            return budgets["cuda:0"]
        return None

    over = {d: n for d, n in totals.items()
            if budget(d) is not None and n > budget(d)}
    return {"totals": totals,
            "budget_bytes": (budget_bytes if budget_bytes is not None
                             else budgets),
            "over_budget": over}


def verdict(budget_bytes: int | None = None) -> dict:
    """The /status device-check contribution: the classification and an
    ok/degraded status with a reason. Degrades only when the accelerator
    was promised (configured backend "gpu" or "tpu") but the ledger
    shows otherwise, or when a device is over its memory."""
    cls = classify()
    out = dict(cls)
    out["status"] = "ok"
    hbm = hbm_check(budget_bytes)
    if hbm["over_budget"]:
        out["status"] = "degraded"
        out["reason"] = (
            "HBM over budget on {}".format(", ".join(
                f"{d} ({n} B)"
                for d, n in sorted(hbm["over_budget"].items()))))
        out["hbm_over_budget"] = hbm["over_budget"]
        return out
    if _CONFIGURED not in PROMISED:
        return out
    state = cls["effective_backend"]
    if state == "mesh_degraded":
        ev = cls["evicted_devices"]
        out["status"] = "degraded"
        out["reason"] = (
            "{} mesh device(s) evicted by per-device breakers ({}); "
            "verify continues on the surviving devices until a "
            "half-open probe re-admits them".format(
                len(ev), ", ".join(ev)))
    elif state == "cpu_fallback":
        out["status"] = "degraded"
        out["reason"] = (
            f"crypto.backend={_CONFIGURED} but launches are landing on "
            "CPU or raising (effective_backend=cpu_fallback; last "
            "successful device launch {}s ago)".format(
                cls["last_device_launch_age_s"]))
    elif state == "idle":
        out["status"] = "degraded"
        out["reason"] = (
            f"crypto.backend={_CONFIGURED} but no device launch "
            f"completed within the {cls['window_s']}s watchdog window")
    elif state == "gpu":
        base = silicon_baseline_ms()
        p50 = cls["exec_p50_ms"]
        if base and p50 and p50 > DRIFT_FACTOR * base:
            out["status"] = "degraded"
            out["baseline_ms"] = base
            out["reason"] = (
                f"device exec p50 {p50} ms drifted >"
                f"{DRIFT_FACTOR:g}x past the recorded silicon "
                f"baseline {base} ms")
    # "unknown" (nothing ever launched) stays ok: a freshly booted node
    # that has not verified yet is not degraded.
    return out
