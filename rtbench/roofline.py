"""Peaks of the card and the least time of a call, copied from the port's
smoke run (``chip_smoke.py``): bytes over the H100's 3.35 TB/s (NVIDIA's
H100 SXM data sheet, at a 700 W power limit), f32 operations over the
card's unfused rate, SMs x 128 FP32 lanes x the maximum SM clock
(``nvidia-smi``'s ``clocks.max.sm``), since the kernels are built with
``--fmad=false`` and every operation is one instruction on one lane."""

from __future__ import annotations

import functools
import subprocess

HBM_BYTES_PER_S = 3.35e12
F32_LANES_PER_SM = 128
# bytes and f32 operations a lane of the shade pass (K3) and of the
# accumulate pass (K4): rays 24 B + the closest state 24 B + miss 4 B in,
# 72 B out; occlusion 4 + a/b 8 + lit 4 + radiance 12 in and 12 out
SHADE_BYTES, ACCUMULATE_BYTES = 124, 40
SHADE_OPS, ACCUMULATE_OPS = 100, 18


@functools.lru_cache(maxsize=None)
def max_sm_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def f32_ops_per_s() -> float:
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * F32_LANES_PER_SM * max_sm_mhz() * 1e6


def least_seconds(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The least time a call moving ``nbytes`` and doing ``ops`` f32
    operations can take."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)
