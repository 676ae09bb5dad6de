"""What the kernel breakdown scripts (``scripts/*_breakdown.py``) share.

A breakdown builds the shipped ``src/repro_torch/kernels/csrc/<name>.cu``
and copies of it with text patches (for timing only: most copies'
outputs are wrong), one ``nvcc`` per source, all started together, and
launches each copy through its wrapper's own ``launch(..., lib=)``, so
the scripts never restate a C signature.  Times are CUDA events around
one call after a ~1 ms device spin with the L2 flushed (the median of
10), as ``chip_smoke.py`` times its kernels, in microseconds.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "breakdown"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

#: variant -> [(text in the source, its replacement)]
Patches = Dict[str, List[Tuple[str, str]]]


def apply(name: str, variant: str, patches: Patches) -> str:
    """The text of ``csrc/<name>.cu`` with ``patches[variant]`` applied;
    exits when a patch target is missing."""
    src = (CSRC / f"{name}.cu").read_text()
    for old, new in patches[variant]:
        if old not in src:
            raise SystemExit(f"{name} {variant}: patch target not found: "
                             f"{old!r}")
        src = src.replace(old, new)
    return src


def patched(name: str, variant: str, patches: Patches) -> Path:
    """``apply``'s text, written to ``OUT``."""
    path = OUT / f"{name}-{variant}.cu"
    path.write_text(apply(name, variant, patches))
    return path


def compile_so(src: Path) -> Path:
    """``nvcc`` ``src`` into a shared library beside it, with the
    package's flags."""
    from repro_torch.kernels import build
    out = src.with_suffix(".so")
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stderr[-3000:]}")
    return out


def build_variants(name: str, patches: Patches,
                   extra: Sequence[Path] = ()):
    """Build every variant of ``csrc/<name>.cu`` (and the ``extra``
    sources) at once; returns ({variant: library with ``name``'s C
    signatures}, [the extra libraries' paths])."""
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    sources = [patched(name, v, patches) for v in patches] + list(extra)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(compile_so, sources))
    libs = {v: build.load(path, name) for v, path in zip(patches, built)}
    return libs, built[len(patches):]


class Timer:
    """CUDA-event times of one call on ``dev``, behind a device spin with
    the L2 flushed."""

    def __init__(self, dev):
        import torch
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def us(self, fn, reps: int = 10) -> float:
        torch = self.torch
        fn()
        fn()
        times = []
        for _ in range(reps):
            torch.cuda._sleep(2_000_000)
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times) * 1e3


def print_card() -> None:
    """The card's name and power limit, and torch's version."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__}")
