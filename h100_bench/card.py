"""The card a run used: its name and the power limit nvidia-smi prints for
it (a card set below its 700 W runs slower under load, so every number is
kept beside it). Copied from deepdenoiser_tpu_torch/tools/_timing.py
(`card_info`) at commit 903e8b8."""

from __future__ import annotations

import subprocess
from typing import Optional

import torch


def power_limit_w(device: torch.device) -> Optional[float]:
    """The card's power limit in W; None where nvidia-smi does not answer."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             f"--id={index}"], capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip())
    except (OSError, subprocess.SubprocessError, ValueError):
        return None
