"""Device selection for the port's entry points.

Entry points take an explicit ``device`` that defaults to ``"cuda"``.
A caller that wants the CPU (the tests do) passes ``device="cpu"``;
asking for CUDA on a machine without a card raises instead of quietly
running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev
