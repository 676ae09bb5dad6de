"""Device selection for the port's entry points.

Entry points take an explicit ``device`` that defaults to ``"cuda"``.
A caller that wants the CPU (the tests do) passes ``device="cpu"``;
asking for CUDA on a machine without a card raises instead of quietly
running on the CPU.
"""
from __future__ import annotations

import functools

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev


def plain_route(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper runs its plain torch version on ``t``:
    a tensor on the CPU, or a ``meta`` tensor (a shape walk such as the
    dry run's, which allocates nothing).  A CUDA tensor launches the
    kernel."""
    return t.device.type in ("cpu", "meta")


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a card; the kernel wrappers size
    their grids from it."""
    return torch.cuda.get_device_properties(device_index) \
        .multi_processor_count


@functools.lru_cache(maxsize=None)
def constant(value: float, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """A 0-dim tensor of ``value`` rounded to ``dtype`` on ``device``,
    filled there once per (value, dtype, device) and then reused: the
    model code's divisors and scalars are a handful of constants, and a
    fresh fill per use would add a device launch to every one."""
    return torch.full((), value, dtype=dtype, device=device)
