"""One run of one cell: everything but the command line.

A cell is found by its name in ``BENCHMARK.json``; its configuration
file (``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``,
whose ``kind`` names the generator module ``kinds/<kind>.py``), its
limits (``limits/<cell>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``) are files of their own, found by name, so a new
cell, mix or metric is new files and entries only.

A run: set-up (the kind's ``Cell``: weights, caches, warm-up), the
measured window, the peak memory, the end-to-end or per-layer metrics,
then the program's state is freed and the plain reference judges
everything the program served.  A traced run (``trace``) goes on from
one stretch to the next without a pause: first ``MFU_SECONDS`` on the
host clock alone (the work and seconds ``step_mfu`` reads); then
``TRACE_SECONDS`` under ``torch.profiler`` with device activity alone
(the device metrics, ``busy_s``, ``window_s``, the busiest device
operations), which costs the host little; then ``HOST_SECONDS`` traced
with host ops and their input shapes too (what needs the launching op,
such as ``moe_dev_ms``, and the idle gaps by what the host was doing),
whose host cost slows a host-bound step about twofold.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import trace as T

#: top-level module names the process must not hold once the window has
#: closed: JAX and the JAX package this port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the untraced stretch of a traced run, whose work over its seconds
#: the ``step_mfu`` readers take
MFU_SECONDS = 20.0
#: the stretch traced with device activity alone
TRACE_SECONDS = 15.0
#: the stretch traced with host ops and input shapes: reading them
#: takes the host seconds for each second of a decode window
HOST_SECONDS = 3.0


@dataclasses.dataclass
class Bench:
    """The benchmark's files under ``root`` (a checkout, or a copy of
    ``BENCHMARK.json`` and the benchmark's folder)."""
    root: Path

    @property
    def folder(self) -> Path:
        return self.root / "portbench"

    def spec(self) -> dict:
        return json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        """Everything a cell's run reads: its entry, configuration,
        traffic, limits and metric entries."""
        spec = self.spec()
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        w = cells[name]
        conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
        e2e = [m for m in spec["end_to_end"]
               if name in m.get("workloads", [name])]
        e2e_names = {m["name"] for m in e2e}
        layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
        return {
            "workload": w,
            "config": json.loads((self.root / conf["file"]).read_text()),
            "traffic": self.data("traffic", w["traffic"]),
            "limits": self.data("limits", name),
            "end_to_end": e2e,
            "per_layer": layer,
        }

    def data(self, kind: str, name: str) -> dict:
        return json.loads((self.folder / kind / f"{name}.json").read_text())

    def module(self, kind: str, name: str):
        """``<folder>/<kind>/<name>.py`` loaded by its path."""
        path = self.folder / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


@dataclasses.dataclass
class Context:
    """What a kind's ``Cell`` is given."""
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: torch.device
    act_bits: Optional[int] = None      # the control's lower precision


@dataclasses.dataclass
class LayerRun:
    """What a per-layer metric's reader reads: the configuration's port
    arch, the traffic, the work the traced stretch did (counts from the
    kind) and its device trace; the work of the untraced stretch before
    it (``timed``, with its ``seconds`` on the host clock); and the
    work and trace of the stretch traced with host ops and input shapes
    (``host``, a ``LayerRun`` of its own)."""
    arch: dict
    port: dict
    traffic: dict
    work: dict
    trace: T.Trace
    timed: Optional[dict] = None
    host: Optional["LayerRun"] = None

    @property
    def window_s(self) -> float:
        return self.trace.window_s


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of pre-sorted values, as
    ``numpy.percentile(..., method="inverted_cdf")`` (the arithmetic of
    the port's ``serving/metrics.percentile``)."""
    if not sorted_vals:
        return float("nan")
    n = len(sorted_vals)
    rank = max(1, min(n, math.ceil(q / 100.0 * n)))
    return sorted_vals[rank - 1]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _device_info(device: torch.device, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": int(peak)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _traced(cell, seconds: float, device, *, host: bool):
    """One stretch of the window under ``torch.profiler``: device
    activity, and with ``host`` the host ops with their input shapes.
    Returns (the stretch's result, its trace)."""
    from torch.profiler import ProfilerActivity, profile
    cpu = ProfilerActivity.CPU
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [cpu]
    if host and cpu not in acts:
        acts.append(cpu)
    prof = profile(activities=acts, record_shapes=host)
    prof.__enter__()
    try:
        with torch.profiler.record_function(T.WINDOW):
            window = cell.window(seconds)
    finally:
        _sync(device)
        prof.__exit__(None, None, None)
    return window, T.read(prof)


def run_cell(bench: Bench, name: str, *, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             act_bits: Optional[int] = None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``t_start`` is the process's start on ``time.perf_counter``'s clock
    (set-up counts from it)."""
    device = torch.device(device)
    spec = bench.cell(name)
    kind = bench.module("kinds", spec["traffic"]["kind"])
    readers = {m["name"]: bench.module("metrics", m["name"])
               for m in spec["per_layer"]} if trace else {}
    ctx = Context(name=name, config=spec["config"], traffic=spec["traffic"],
                  limits=spec["limits"], seed=seed, device=device,
                  act_bits=act_bits)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        cell = kind.Cell(ctx)
        _sync(device)
        setup_s = time.perf_counter() - t_start
        metrics: Dict[str, dict] = {}
        if trace:
            timed = cell.window(min(seconds, MFU_SECONDS))
            traced, tr = _traced(cell, min(seconds, TRACE_SECONDS), device,
                                 host=False)
            window, host_tr = _traced(cell, min(seconds, HOST_SECONDS),
                                      device, host=True)
            run = LayerRun(arch=ctx.config["port"]["arch"],
                           port=ctx.config["port"], traffic=ctx.traffic,
                           work=traced["work"], trace=tr,
                           timed=timed["work"])
            run.host = dataclasses.replace(run, work=window["work"],
                                           trace=host_tr)
        else:
            window = cell.window(seconds)
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0
        t_read = time.perf_counter()
        if trace:
            for m in spec["per_layer"]:
                value = readers[m["name"]].read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            busy = T.busy_s(tr)
            breakdown = T.breakdown(tr, host_tr)
            print(f"portbench: traced {tr.window_s:.2f} s of "
                  f"{traced['work']['seconds']:.2f} on the host clock ("
                  f"{len(tr.events)} device events), then "
                  f"{host_tr.window_s:.1f} s with host ops "
                  f"({len(host_tr.host)} host events, busy "
                  f"{T.busy_s(host_tr):.2f} s); readers "
                  f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
            del run
        else:
            values = dict(window["end_to_end"], setup_s=setup_s)
            for m in spec["end_to_end"]:
                if m["name"] not in values:
                    raise KeyError(f"kind {spec['traffic']['kind']!r} "
                                   f"does not measure {m['name']!r}")
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        t_window = time.perf_counter()
        cell.free_program()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = cell.check()
    del cell
    print(f"portbench: {name} seed {seed}: set-up {setup_s:.1f} s, window "
          f"and readers {t_window - t_start - setup_s:.1f} s, reference "
          f"{time.perf_counter() - t_window:.1f} s", file=sys.stderr)
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and bool(checks)
    dev = _device_info(device, peak)
    if trace:
        dev.update(busy_s=busy, window_s=tr.window_s)
    out = {"correct": correct, "attempted": window["attempted"],
           "failed": window["failed"], "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
