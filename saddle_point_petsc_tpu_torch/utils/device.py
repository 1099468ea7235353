"""Where the library API puts its tensors.

The port runs on the card: every entry point that creates tensors from
sizes or host arrays takes `device=None` to mean CUDA, and raises without
a card rather than run on the CPU unasked. The CPU runs only when the
caller passes `device="cpu"` (the CPU tests do).
"""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """None -> torch.device("cuda"), raising without a CUDA device; a name
    or torch.device -> that device (a CUDA one must exist)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: use cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA device is available (pass device='cpu' for the CPU)")
    return dev


def card_line(dev):
    """The card's name and power limit as nvidia-smi prints them; on the CPU,
    its thread count."""
    if dev.type != "cuda":
        return f"cpu, {torch.get_num_threads()} threads"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", f"--id={dev.index}"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]
