"""The machine a run names beside its numbers: the cards' names and power
limits from ``nvidia-smi``, and the host CPU (copied from chip_smoke.py's
``cpu_model`` and ``nvidia_smi_line``)."""

from __future__ import annotations

import os
import subprocess


def cpu_model() -> str:
    """The host CPU's model from /proc/cpuinfo: its model name, or, where
    the kernel reports that as unknown, vendor, family and model number."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if not ln.strip():
                    break  # the first processor's block
                key, _, value = ln.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        return "unknown"
    name = fields.get("model name", "unknown")
    if name != "unknown":
        return name
    return (f"{fields.get('vendor_id', '?')} family {fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')} (model name unknown), {fields.get('cpu MHz', '?')} MHz")


def power_limits(count: int) -> list:
    """The ``count`` visible cards' power limits in W, as ``nvidia-smi``
    reads them (None where it cannot); ``nvidia-smi`` numbers every card,
    so the visible ones are picked by ``CUDA_VISIBLE_DEVICES``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return [None] * count
    vals = []
    for ln in out.stdout.split():
        try:
            vals.append(float(ln))
        except ValueError:
            vals.append(None)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    ids = [int(i) for i in visible.split(",")] if visible.replace(",", "").isdigit() else []
    ids = (ids or list(range(count)))[:count]
    return [vals[i] if i < len(vals) else None for i in ids]
