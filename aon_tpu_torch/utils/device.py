"""Device selection for the port's entry points."""

from __future__ import annotations

import subprocess
from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The device an entry point runs on; raises if CUDA is asked for and absent.

    Entry points default to ``"cuda"`` and never drop to the CPU on their own:
    a caller that wants the plain PyTorch path passes ``device="cpu"``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return device


def card_name(device: DeviceLike = "cuda") -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (its first card; torch's name where
    ``nvidia-smi`` cannot be run), or ``"cpu"``: the line that stands beside
    every time a script prints."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return smi[0] if smi else torch.cuda.get_device_name(torch.device(device))
