"""The card's peaks, against which every roofline share is taken.

HBM bandwidth and the float32 rate outside the tensor cores are NVIDIA's
published figures for the H100 (SXM: 3.35 TB/s, 67 TFLOP/s; PCIe: 2.0
TB/s, 51 TFLOP/s).  The int32 rate is read from the card: its SMs x 64
int32 lanes x its maximum SM clock.  The power limit is read beside
them, since a card set below 700 W reaches less.
"""
from __future__ import annotations

import subprocess

PUBLISHED = {"sxm": (3.35e12, 67e12), "pcie": (2.0e12, 51e12)}
INT32_LANES_PER_SM = 64


def _smi(field: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits",
         "-i", "0"], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def read(torch) -> dict:
    """Peaks of card 0: bytes/s, int32 and f32 operations/s, and its power
    limit (W) and name."""
    name = torch.cuda.get_device_name(0)
    hbm, f32 = PUBLISHED["pcie" if "PCIE" in name.upper() else "sxm"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_smi("clocks.max.sm"))
    return {"name": name, "bytes_per_s": hbm, "f32_per_s": f32,
            "int32_per_s": sms * INT32_LANES_PER_SM * mhz * 1e6,
            "power_limit_w": float(_smi("power.limit"))}
