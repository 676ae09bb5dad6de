"""The readers of the program's spans (``portbench/spans.py`` and the
metrics that use them) on made-up traces, and the program's record of
its expert choices against the benchmark's own spy on ``moe_route``."""
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, spans, trace as T

BENCH = harness.Bench(Path(__file__).resolve().parent.parent)


class Host:
    """A host event of a kineto trace, as the readers see one."""
    def __init__(self, name, start, end, tid=7):
        self._n, self._a, self._b, self._t = name, start, end, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def start_thread_id(self):
        return self._t

    def shapes(self):
        return []


def _trace(with_spans=True):
    """A step [0, 100) with one layer's attention and MoE FFN: a kernel
    launched by an aten op inside ``attn.kv``, one launched straight
    from ``attn.core`` (a ctypes launch links to the span), B7 from
    ``moe.experts``, one from the head, and one outside every span."""
    p = spans.PROGRAM if with_spans else "other."
    step = Host(p + "decode_step", 0, 100)
    kv = Host(p + "attn.kv", 10, 20)
    copy = Host("aten::copy_", 12, 14)
    core = Host(p + "attn.core", 20, 30)
    moe = Host(p + "moe", 40, 80)
    experts = Host(p + "moe.experts", 50, 70)
    head = Host(p + "head", 85, 95)
    argmax = Host("aten::argmax", 110, 120)
    host = dict(enumerate([step, kv, copy, core, moe, experts, head,
                           argmax]))
    ms = 10 ** 6
    events = [T.DeviceEvent("direct_copy_kernel", 0, 3 * ms, copy),
              T.DeviceEvent("softmax", 0, 5 * ms, core),
              T.DeviceEvent("unpack_dequant_kernel", 0, 7 * ms, experts),
              T.DeviceEvent("gemm", 0, 11 * ms, head),
              T.DeviceEvent("argmax", 0, 13 * ms, argmax),
              T.DeviceEvent("orphan", 0, 17 * ms, None)]
    return T.Trace(0, 200, events, host, 7)


def _run(trace, work):
    host = harness.LayerRun(arch={}, port={}, traffic={}, work=work,
                            trace=trace)
    empty = T.Trace(0, 0, [], {}, None)
    return harness.LayerRun(arch={}, port={}, traffic={}, work=work,
                            trace=empty, host=host)


@pytest.mark.parametrize("names,ms", [
    (("attn.kv", "attn.core"), 8.0), (("moe",), 7.0),
    (("moe.experts",), 7.0), (("head",), 11.0), (("decode_step",), 26.0)])
def test_span_ms(names, ms):
    assert spans.span_ms(_trace(), names) == pytest.approx(ms)
    assert spans.span_ms(_trace(with_spans=False), names) is None


#: each metric's reading of ``_trace`` over 2 model calls and 4,000
#: prompt tokens
READINGS = {"attn_dev_ms.decode": 4.0, "moe_ffn_dev_ms.decode": 3.5,
            "lm_head_dev_ms.decode": 5.5, "attn_dev_ms.prefill": 2.0}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_metric_readers(metric):
    read = BENCH.module("metrics", metric).read
    work = {"calls": [[32, 32, 2]], "tokens": 4000}
    assert read(_run(_trace(), work)) == pytest.approx(READINGS[metric])
    assert read(_run(_trace(with_spans=False), work)) is None
    no_host = _run(_trace(), work)
    no_host.host = None
    assert read(no_host) is None
    idle = _run(_trace(), work)
    idle.host.trace = T.Trace(0, 200, [], _trace().host, 7)
    assert read(idle) is None                       # no device events
    assert read(_run(_trace(), {"calls": [], "tokens": 0})) is None


def test_expert_routes_equal_the_benchmarks_spy():
    """``tracing.expert_routes`` records what ``program.expert_choices``'
    patch of ``moe_route`` records, call for call, on a reduced
    phi3.5-moe decode."""
    import repro_torch.models as tm
    from repro_torch import tracing
    from repro_torch.configs.registry import get_arch
    from portbench import program
    cfg = get_arch("phi3.5-moe").reduced()
    q = tm.serve_params(tm.init_params(cfg, seed=2, device="cpu"), bits=4,
                        min_size=1024, compute="sdv")
    rng = np.random.default_rng(5)
    cache = tm.init_cache(cfg, 4, 8, device="cpu")
    with program.expert_choices() as spied, \
            tracing.expert_routes() as recorded:
        for _ in range(3):
            toks = torch.tensor(rng.integers(0, cfg.vocab, (4, 1)),
                                dtype=torch.int32)
            _, cache = tm.decode_step(cfg, q, cache, toks)
    assert len(recorded) == len(spied) == 3 * cfg.n_layers
    assert all(r[0] is s for r, s in zip(recorded, spied))
