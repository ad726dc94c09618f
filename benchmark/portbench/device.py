"""The card a run uses: its name, count, power limit and published peaks."""

from __future__ import annotations

import shutil
import subprocess

import torch

from portbench.spec import BENCH_DIR, load_json


def power_limit_w() -> float | None:
    """The card's power limit from nvidia-smi, or None where it cannot be read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        res = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(res.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def peaks(name: str) -> dict:
    """{"fp32_flops", "bytes_per_s"} of the named part (data/peaks.json)."""
    for part in load_json(BENCH_DIR / "data" / "peaks.json")["parts"]:
        if part["match"] in name:
            return {"fp32_flops": float(part["fp32_flops"]), "bytes_per_s": float(part["bytes_per_s"])}
    raise KeyError(f"no published peak for {name!r} in data/peaks.json")


def describe(count: int) -> dict:
    name = torch.cuda.get_device_name(0)
    return {"platform": "gpu", "kind": name, "count": count, "power_limit_w": power_limit_w(), **peaks(name)}
