"""The peaks of the NVIDIA cards the port measures on: MFU and bound denominators.

The port's counterpart of ``GENERATIONS`` (:mod:`.tpu`) for the card a step
runs on.  One entry per card whose published peaks are known; a card that
:func:`detect_card` does not recognise gets no peak, so a bench line for it
carries no ``mfu`` (never a guessed one).
"""

from __future__ import annotations

import re
import subprocess
from typing import Dict, Optional

# Published dense peaks (NVIDIA H100 data sheet, SXM part at its 700 W limit;
# no sparsity).  A card set below 700 W runs slower under load: every
# number measured against these is kept beside the card's power limit.
CARDS: Dict[str, dict] = {
    "h100-sxm": {
        "bf16_flops": 989e12,
        "bytes_per_s": 3.35e12,
    },
}


def detect_card(name: str) -> Optional[str]:
    """The :data:`CARDS` key of a card from its name as
    ``torch.cuda.get_device_name`` gives it, or None for a card whose peaks
    are not in the table.  The SXM H100 names itself by its memory
    ("NVIDIA H100 80GB HBM3"); the PCIe and NVL parts, with other peaks, do
    not match."""
    n = name.upper()
    if "H100" in n and ("HBM3" in n or "SXM" in n):
        return "h100-sxm"
    return None


def nvidia_smi_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``); raises if it fails."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0 or not res.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def power_limit_w(smi_line: str) -> Optional[float]:
    """The power limit in watts from :func:`nvidia_smi_line`'s line, or
    None when it reads no number (``[N/A]``)."""
    m = re.search(r"([0-9.]+)\s*W\s*$", smi_line)
    return float(m.group(1)) if m else None
