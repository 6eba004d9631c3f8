"""Device choice for the port's entry points.

Entry points run on the card: with no `device` argument they take
"cuda", and they raise when there is none. The CPU is used only when the
caller asks for it (the tests do), never as a silent fallback.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def for_rank(local_rank: int, device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device of a data-parallel rank: "cpu" when asked for, else the
    card cuda:(local_rank % device_count), so ranks on a host spread over
    its cards and share them when there are more ranks than cards."""
    dev = resolve(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", local_rank % torch.cuda.device_count())
