"""What the per-layer readers of more than one traffic kind compute from a
traced run's record; each metric's own file under ``benchmark/metrics/``
says which record it reads."""
from __future__ import annotations


def idle_share(record):
    """100 * (1 - busy / window) of the device-only traced stretch: the
    share of its time in which no device operation ran, the busy time the
    union of the operations' intervals."""
    t = record.get("trace")
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(record):
    """Model FLOPs of the units the window completed over the window's
    seconds and the card's bf16 dense tensor peak, in %."""
    if not record.get("flops") or not record.get("peaks"):
        return None
    done = record["flops"]["total"] * record["units"]
    return 100.0 * done / record["window_s"] / record["peaks"][0]
