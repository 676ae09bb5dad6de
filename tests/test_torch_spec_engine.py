"""The torch port's speculative serving engine keeps the reference's
invariants (the JAX package's ``tests/test_spec.py``), on reduced
tinyllama-1.1b (2 layers, d_model 128, vocab 512) on the CPU, where the
kernels run their plain versions: a speculative engine gives plain
decode's token streams (SDV at chunk 4 and 1, memory mode, random and
calibrated weights); a calibrated checkpoint accepts more than one token
a round; a draft failure degrades the bucket to plain decode; the
accept-EMA blend of the admission estimate; the ``spec_report`` schema;
the loadgen ``drained`` outcome; and ``loadgen --speculative`` and
``serve --engine on --speculative`` on the CPU.  The engine's parity
with the reference's engine is in ``tests/test_torch_spec.py``.
"""
import json

import numpy as np
import pytest
import torch

import repro_torch.models as tm
from repro_torch.configs.registry import get_arch
from repro_torch.serving import BucketShape, Engine
from repro_torch.serving import loadgen
from repro_torch.serving.spec import calibrated_params

ROWS = 2                     # bucket width
K = 3                        # drafted tokens per round
BUCKET = BucketShape(ROWS, 16)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small CPU tensors: more only contend
    with the test workers running beside this one (the 120 calibration
    steps took 476.8 s under six workers at torch's default thread
    count) and are slower here even alone.  The tests assert properties
    of the runs, not bits, so the order of the sums may change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_arch("tinyllama-1.1b").reduced()
    return dict(cfg=cfg, params=tm.init_params(cfg, seed=0, device="cpu"))


def _serve(s, params, *, speculative, prefill_chunk=4, n=4, seed=11,
           **kw):
    eng = Engine(s["cfg"], params, buckets=(BUCKET,),
                 speculative=speculative, prefill_chunk=prefill_chunk,
                 spec_k=K, plan_policy="auto", device="cpu", **kw)
    rng = np.random.default_rng(seed)
    rids = [eng.submit([int(x) for x in rng.integers(0, s["cfg"].vocab,
                                                     2 + i % 4)],
                       new_tokens=3 + i % 3) for i in range(n)]
    eng.drain()
    toks = {c.rid: c.tokens for c in eng.completions}
    return [toks[r] for r in rids], eng


@pytest.fixture(scope="module")
def sdv_pair(tiny):
    """Plain and speculative SDV engines over the same requests."""
    return (_serve(tiny, tiny["params"], speculative=False),
            _serve(tiny, tiny["params"], speculative=True))


def test_engine_spec_equals_plain_sdv(sdv_pair):
    """Random-init weights: acceptance is low, so most rounds reject and
    roll back, and the tokens are still plain decode's."""
    (plain, _), (spec, eng) = sdv_pair
    assert plain == spec
    sp = eng.metrics.snapshot()["speculative"]
    assert sp["rounds"] > 0 and sp["degraded_buckets"] == 0
    assert sp["plain_decode_launches"] == 0


@pytest.mark.parametrize("compute,chunk", [("sdv", 1), ("memory", 4)])
def test_engine_spec_equals_plain(tiny, compute, chunk):
    """Chunk 1 (spec mode still replays prompts through the chunked
    prefill: a round never races teacher forcing) and memory mode (the
    draft is the W4 memory-packed tree)."""
    kw = dict(prefill_chunk=chunk, compute=compute, n=3)
    plain, _ = _serve(tiny, tiny["params"], speculative=False, **kw)
    spec, eng = _serve(tiny, tiny["params"], speculative=True, **kw)
    assert plain == spec
    sp = eng.metrics.snapshot()["speculative"]
    assert sp["rounds"] > 0 and sp["degraded_buckets"] == 0


def test_spec_report_schema(sdv_pair):
    (_, plain), (_, eng) = sdv_pair
    rep = eng.spec_report()
    assert list(rep) == [BUCKET.key]
    for v in rep.values():
        assert v["spec_on"] is True and v["accept_ema"] >= 1.0
        assert len(v["layers"]) == 8
        assert all(l["draft_denser"] for l in v["layers"])
    assert plain.spec_report() == {}


def test_cache0_and_target_cache_untouched_by_the_draft(sdv_pair):
    """The draft writes only its fork: after the waves, ``cache0`` is
    still all zeros and the fork has its own storage."""
    _, (_, eng) = sdv_pair
    st = eng._states[BUCKET.key]
    assert all(bool((v == 0).all()) for v in st.cache0.values())
    assert set(st.draft_work) == set(st.work)
    assert all(st.draft_work[k].data_ptr() != st.work[k].data_ptr()
               for k in st.work)


def test_engine_spec_accepts_on_calibrated(tiny):
    """On a briefly trained checkpoint (the reference's test takes 120
    steps) the W4A4 draft agrees with the W4A8 target: more than one
    token a round on average, some rounds accept two or more, and the
    tokens are still plain decode's."""
    params = calibrated_params(tiny["cfg"], steps=120, seed=0, device="cpu")
    plain, _ = _serve(tiny, params, speculative=False, n=3)
    spec, eng = _serve(tiny, params, speculative=True, n=3)
    assert plain == spec
    sp = eng.metrics.snapshot()["speculative"]
    assert sp["mean_accepted"] > 1.0
    assert any(int(k) >= 2 for k in sp["acceptance_hist"])
    assert eng._states[BUCKET.key].accept_ema > 1.0


def test_engine_spec_degrades_to_plain_decode(tiny, sdv_pair):
    """A draft failure at run time turns speculation off for the bucket
    and serves the same wave with plain decode on the SAME bucket: no
    quarantine, no batch-1 fallback, plain decode's tokens."""
    (plain, _), _ = sdv_pair
    eng = Engine(tiny["cfg"], tiny["params"], buckets=(BUCKET,),
                 speculative=True, prefill_chunk=4, spec_k=K,
                 plan_policy="auto", device="cpu")
    eng.warmup(BUCKET)
    assert eng._states[BUCKET.key].spec_on

    def boom(*a, **kw):
        raise RuntimeError("draft device fault")
    eng.spec.draft = boom
    rng = np.random.default_rng(11)
    rids = [eng.submit([int(x) for x in rng.integers(0, tiny["cfg"].vocab,
                                                     2 + i % 4)],
                       new_tokens=3 + i % 3) for i in range(4)]
    with pytest.warns(UserWarning, match="degrading to plain decode"):
        eng.drain()
    toks = {c.rid: c.tokens for c in eng.completions}
    assert [toks[r] for r in rids] == plain
    snap = eng.metrics.snapshot()
    assert snap["speculative"]["degraded_buckets"] == 1
    assert snap["faults"]["fallback_waves"] == 0
    assert snap["faults"]["quarantines"] == 0
    assert not eng._states[BUCKET.key].spec_on
    assert all(o["outcome"] == "ok" for o in eng.outcomes.values())


def test_warm_spec_failure_degrades_the_bucket(tiny):
    """A draft that cannot be built at warmup leaves the bucket serving
    plain decode (spec_on False, one degraded bucket), not failed."""
    eng = Engine(tiny["cfg"], tiny["params"], buckets=(BUCKET,),
                 speculative=True, spec_k=K, plan_policy="auto",
                 device="cpu")

    def no_draft(rows):
        raise RuntimeError("no draft plan")
    eng.spec.draft_qparams = no_draft
    with pytest.warns(UserWarning, match="degrading to plain decode"):
        st = eng.warmup(BUCKET)
    assert st.warmed and not st.spec_on
    assert eng.metrics.snapshot()["speculative"]["degraded_buckets"] == 1


def test_est_wave_s_blends_accept_ema(tiny):
    """A speculating bucket's wave estimate divides the round-priced
    decode EMA by the acceptance EMA; a degraded bucket, one without
    data and a plain engine keep the plain estimate."""
    kw = dict(clock=FakeClock(), buckets=(BucketShape(2, 21),),
              plan_policy="auto", device="cpu")
    eng = Engine(tiny["cfg"], tiny["params"], speculative=True, **kw)
    st = eng._state(BucketShape(2, 21))
    st.warmed, st.decode_s = True, 0.01           # 0.2 s plain estimate
    st.spec_on, st.accept_ema = True, 4.0
    assert eng._est_wave_s() == pytest.approx(0.05)
    st.spec_on = False
    assert eng._est_wave_s() == pytest.approx(0.2)
    st.spec_on, st.accept_ema = True, 0.0
    assert eng._est_wave_s() == pytest.approx(0.2)
    plain = Engine(tiny["cfg"], tiny["params"], **kw)
    pst = plain._state(BucketShape(2, 21))
    pst.warmed, pst.decode_s, pst.accept_ema = True, 0.01, 4.0
    assert plain._est_wave_s() == pytest.approx(0.2)


def test_loadgen_drained_outcome(tiny):
    """EngineDraining is terminal for the client: a distinct ``drained``
    outcome, never retried like Backpressure."""
    eng = Engine(tiny["cfg"], tiny["params"], buckets=(BucketShape(4, 64),),
                 plan_policy="auto", device="cpu")
    eng._admitting = False
    snap = loadgen.run_poisson(eng, rate=80.0, duration_s=0.1,
                               prompt_len=4, new_tokens=2,
                               rng=np.random.default_rng(0), retries=3)
    counts = snap["client_outcomes"]
    assert counts["drained"] == snap["offered_requests"] > 0
    assert counts["rejected"] == 0
    assert snap["retried_submissions"] == 0


def test_loadgen_speculative_cli(tmp_path, capsys):
    """``loadgen --speculative`` on the CPU: a calibrated checkpoint, one
    rate, a plain and a speculative point with the reference's payload
    keys, every audited request bit-exact."""
    path = tmp_path / "spec.json"
    payload = loadgen.main([
        "--speculative", "--device", "cpu", "--rates", "60",
        "--duration", "0.04", "--train-steps", "3", "--batch", "2",
        "--buckets", "10", "--prompt-len", "3", "--new-tokens", "3",
        "--json", str(path)])
    assert payload["bench"] == "speculative_decoding"
    assert payload["backend"] == "cpu" and payload["calibration_steps"] == 3
    assert json.loads(path.read_text())["points"] == \
        json.loads(json.dumps(payload["points"]))
    assert [p["speculative"] for p in payload["points"]] == [False, True]
    for p in payload["points"]:
        for key in ("p99_ms", "tokens_per_target_wave", "mean_accepted",
                    "acceptance_hist", "spec_degraded", "spec_counters",
                    "p99_ms_trials", "bit_exact_checked"):
            assert key in p, key
        assert p["bit_exact_mismatches"] == 0 and p["bit_exact_checked"] > 0
    assert payload["points"][1]["spec_counters"]["rounds"] > 0
    assert list(payload["plan_table"]) == ["b2.s10"]
    out = capsys.readouterr().out
    assert "spec  @   60.0 req/s" in out and "strictly denser" in out


def test_serve_cli_speculative_on_cpu(capsys):
    from repro_torch.launch.serve import main
    assert main(["--engine", "on", "--speculative", "--device", "cpu",
                 "--smoke", "--plan-policy", "auto", "--batch", "2",
                 "--prompt-len", "3", "--new-tokens", "3",
                 "--requests", "2"]) == 0
    out = capsys.readouterr().out
    assert "speculative k=3 (draft W4A4)" in out
    assert "2 done (0 rejected, 0 shed)" in out
    assert "speculative: " in out
    assert "8/8 draft layers strictly denser" in out
