"""repro_torch.serving.ServingEngine against the JAX package's engine, on
the reference's qwen2.5 SMOKE weights (carried over by convert): the
scenarios of tests/test_serving.py, each run through both engines, with
the same tokens out and the same stats() counters (admission, decode
steps, tokens, truncation, compile-cache hits and misses)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import init_params as ref_init
from repro.serving import Request as RefRequest
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import forward
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.serving.engine import _batch_axis


@pytest.fixture(autouse=True)
def pin_prng_mode():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(scope="module")
def setup():
    rc = ref_config("qwen2.5-14b", smoke=True)
    pc = get_config("qwen2.5-14b", smoke=True)
    rp = ref_init(jax.random.PRNGKey(0), rc)
    pp = convert.lm_params_from_jax(jax.tree.map(np.asarray, rp), pc, "cpu")
    return rc, pc, rp, pp


def _engines(setup, impl="chunked", **serve):
    rc, pc, rp, pp = setup
    rc, pc = (dataclasses.replace(c, attention_impl=impl) for c in (rc, pc))
    return (RefEngine(rp, rc, RefServeConfig(**serve)),
            ServingEngine(pp, pc, ServeConfig(**serve)))


def _requests(specs):
    """specs: (rid, prompt, max_new) -> (reference, port) request lists."""
    return ([RefRequest(rid=r, prompt=p, max_new=m) for r, p, m in specs],
            [Request(rid=r, prompt=p, max_new=m) for r, p, m in specs])


def _outcome(reqs):
    return [(r.rid, r.out, r.done, r.truncated) for r in reqs]


def _serve_both(setup, specs, impl="chunked", max_steps=10_000, **serve):
    ref_eng, eng = _engines(setup, impl, **serve)
    ref_reqs, reqs = _requests(specs)
    want = ref_eng.run(ref_reqs, max_steps=max_steps)
    got = eng.run(reqs, max_steps=max_steps)
    assert _outcome(got) == _outcome(want)
    assert eng.stats() == ref_eng.stats()
    return got, eng


def test_engine_matches_full_forward_generation(setup):
    rc, pc, rp, pp = setup
    prompt = np.arange(7) % pc.vocab
    toks, want = list(prompt), []
    with torch.inference_mode():
        for _ in range(5):
            logits, _ = forward(pp, {"tokens": torch.tensor([toks])}, pc)
            want.append(int(torch.argmax(logits[0, -1])))
            toks.append(want[-1])
    got, _ = _serve_both(setup, [(0, prompt, 5)], batch_slots=2, max_len=64)
    assert got[0].out == want


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_engine_serves_more_requests_than_slots(setup, impl):
    specs = [(i, np.arange(4 + i) % 512, 6) for i in range(7)]
    done, _ = _serve_both(setup, specs, impl, batch_slots=3, max_len=64)
    assert len(done) == 7 and all(len(r.out) == 6 for r in done)


def test_engine_stats_counters(setup):
    ref_eng, eng = _engines(setup, batch_slots=2, max_len=64)
    ref_reqs, reqs = _requests([(i, np.arange(4) % 512, 3)
                                for i in range(5)])
    admitted = [eng.add_request(r) for r in reqs]
    assert admitted == [ref_eng.add_request(r) for r in ref_reqs]
    assert admitted == [True, True, False, False, False]
    assert eng.stats() == ref_eng.stats()
    s = eng.stats()
    assert s["admitted"] == 2 and s["rejected"] == 3
    assert s["slots_live"] == 2 and s["slots_free"] == 0
    done = eng.run([r for r, ok in zip(reqs, admitted) if not ok])
    want = ref_eng.run([r for r, ok in zip(ref_reqs, admitted) if not ok])
    assert _outcome(done) == _outcome(want) and len(done) == 5
    assert all(r.done for r in reqs)
    assert eng.stats() == ref_eng.stats()
    cc = eng.stats()["compile_cache"]
    assert cc["misses"] >= 2 and cc["hits"] > cc["misses"]


def test_engine_run_truncates_instead_of_dropping(setup):
    ref_eng, eng = _engines(setup, batch_slots=2, max_len=64)
    specs = [(i, np.arange(4) % 512, 50) for i in range(4)]
    ref_reqs, reqs = _requests(specs)
    done = eng.run(reqs, max_steps=3)
    assert _outcome(done) == _outcome(ref_eng.run(ref_reqs, max_steps=3))
    assert {r.rid for r in done} == {0, 1, 2, 3}
    assert sum(r.truncated for r in done) == 4
    assert eng.stats() == ref_eng.stats()
    assert eng.stats()["slots_live"] == 0 and eng.stats()["queue_depth"] == 0
    [ok] = eng.run([Request(rid=9, prompt=np.arange(4) % 512, max_new=3)])
    assert ok.done and not ok.truncated


def test_engine_run_returns_all_in_completion_order(setup):
    specs = [(i, np.arange(4) % 512, 2 + 3 * i) for i in range(4)]
    done, _ = _serve_both(setup, specs, batch_slots=2, max_len=64)
    assert [r.rid for r in done] == [0, 1, 2, 3]
    assert all(r.done and not r.truncated for r in done)


def test_engine_length_limit_and_pos(setup):
    """A slot stops at max_len - 1 (the reference's rule) and positions
    stay int32."""
    done, eng = _serve_both(setup, [(0, np.arange(10) % 512, 50)],
                            batch_slots=1, max_len=16)
    assert done[0].done and len(done[0].out) == 6
    assert eng.pos.dtype == np.int32


def test_engine_interleaved_lengths_are_isolated(setup):
    pa, pb = np.arange(5) % 512, (np.arange(9) * 3) % 512
    alone = [_serve_both(setup, [(0, p, 4)], batch_slots=1, max_len=64)[0][0]
             .out for p in (pa, pb)]
    done, _ = _serve_both(setup, [(0, pa, 4), (1, pb, 4)], batch_slots=2,
                          max_len=64)
    assert {r.rid: r.out for r in done} == {0: alone[0], 1: alone[1]}


def test_batch_axis():
    assert _batch_axis((4, 2, 64, 32), (1, 2, 64, 32), 4) == 0
    assert _batch_axis((1, 2, 64, 32), (1, 2, 64, 32), 1) == 0
    assert _batch_axis((2, 4, 8), (2, 1, 8), 4) == 1
    with pytest.raises(ValueError):
        _batch_axis((2, 3), (2, 3), 4)
