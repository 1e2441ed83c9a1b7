"""The card a run measures, as ``nvidia-smi`` names it (copied from
``raytpu_torch/bench.py``'s ``device_info``)."""

from __future__ import annotations

import subprocess


def device_info(index: int = 0) -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[index]
    name, limit = (x.strip() for x in line.rsplit(",", 1))
    return {"name": name, "power_limit_w": float(limit.split()[0]),
            "torch": torch.__version__, "cuda": torch.version.cuda}
