"""The port's engine hooks for online serving, and an untied LM head,
against the JAX package's.

* An untied head (the smollm smoke config with ``tie_embeddings=False``)
  serves: the port's greedy streams equal JAX's on the same packed
  weights, baseline and speculating (k = 3, draft bitwidth 6); the draft
  view re-grids ``embed.head`` with the other leaves in one grouped K7
  call.
* ``token_sink``/``finish_sink``: the port fires the same events in the
  same order as JAX on one trace with an abort mid-flight and a queued
  abort.
* ``drain_finished`` and admission fault isolation (``ADMIT_FAIL_TRIP``),
  as JAX's ``tests/test_serving.py`` holds its engine, plus the
  copy-on-write hold of a failing prefix hit.
* ``RequestMetrics.decode_tps`` and ``tree_code_stats`` against JAX, and
  ``Engine.numerics_snapshot`` against JAX's on the same draft view.

Integers (tokens, events, counts) are held equal; ``decode_tps`` to the
last bit (the same float ops); the draft view's mean relative re-grid
error to 1e-6 relative (two f32 sums in different orders over ~30k
elements).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.core.lns import LNSFormat as JFormat  # noqa: E402
from repro.core.quantizer import QuantConfig as JQuantConfig  # noqa: E402
from repro.kernels import dispatch as jd  # noqa: E402
from repro.optim.madam import MadamConfig  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.training import init_train_state  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.core.lns import LNSFormat  # noqa: E402
from repro_torch.core.quantizer import QuantConfig  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.serving.engine import ADMIT_FAIL_TRIP  # noqa: E402

from test_torch_model import flat_params, jax_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    cfg, qcfg, mcfg, params = jax_smoke()
    tp = params_from_flat(flat_params(params), LNSFormat(8, 8), device="cpu")
    return cfg, qcfg, mcfg, params, tp


def _engine(tp, cfg=None, **kw):
    return Engine(cfg or get_smoke_config("smollm-135m"),
                  QuantConfig.lns_madam(), tp, device="cpu", **kw)


def _by_rid(engine):
    return {rs.request.rid: list(rs.generated) for rs in engine.finished}


def _prompts(vocab, n, length, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (n, length))


# ---------------------------------------------------------------------------
# an untied LM head

@pytest.fixture(scope="module")
def untied():
    jcfg = dataclasses.replace(j_smoke_config("smollm-135m"),
                               tie_embeddings=False)
    tcfg = dataclasses.replace(get_smoke_config("smollm-135m"),
                               tie_embeddings=False)
    mcfg = MadamConfig(update_format=JFormat(bits=8, gamma=8))
    params = jax.jit(lambda k: init_train_state(k, jcfg, mcfg).params)(
        jax.random.PRNGKey(0))
    tp = params_from_flat(flat_params(params), LNSFormat(8, 8), device="cpu")
    assert "head" in tp["embed"]
    return jcfg, mcfg, params, tcfg, tp


@pytest.mark.parametrize("spec_k", [0, 3])
def test_untied_head_serves_as_jax(untied, spec_k, monkeypatch):
    jcfg, mcfg, jparams, tcfg, tp = untied
    prompts = _prompts(jcfg.vocab_size, 4, 9, seed=3)
    kw = dict(num_slots=3, max_len=32, page_size=4, speculate_k=spec_k)
    with jd.configured(backend="reference"):
        je = JEngine(jcfg, JQuantConfig.lns_madam(), mcfg, jparams, **kw)
        je.run([JRequest(rid=i, prompt=p.tolist(), max_new_tokens=6)
                for i, p in enumerate(prompts)])
    groups = []
    real = dispatch.requant_pack_many
    monkeypatch.setattr(dispatch, "requant_pack_many", lambda words, *a: (
        groups.append(len(words)), real(words, *a))[1])
    te = _engine(tp, tcfg, **kw)
    te.run([Request(rid=i, prompt=p.tolist(), max_new_tokens=6)
            for i, p in enumerate(prompts)])
    assert _by_rid(te) == _by_rid(je)
    assert te.decode_steps == je.decode_steps
    if spec_k:
        assert te.spec_cycles == je.spec_cycles > 0
        assert te.spec_accepted == je.spec_accepted
        view, head = te._draft_params(6)
        assert head is view["embed"]["head"]
        assert head.fmt.bits == 6 and head.packed.shape == (
            tcfg.d_model, tcfg.vocab_size)
        n_packed = sum(hasattr(w, "packed") for w in (
            tp["embed"]["tok"], tp["embed"]["head"],
            *tp["period"]["pos0"]["attn"].values(),
            *tp["period"]["pos0"]["mlp"].values()))
        assert groups == [n_packed]      # one grouped call, head included
    else:
        assert groups == []


# ---------------------------------------------------------------------------
# the sinks

def _sink_events(mk, R, vocab):
    """Every sink event of one trace: three requests on two slots, one
    aborted mid-decode, one aborted while queued, one completing."""
    events = []
    e = mk(num_slots=2, max_len=32, page_size=4)
    e.token_sink = lambda rid, tok: events.append(("token", rid, int(tok)))
    e.finish_sink = lambda rid, reason, rs: events.append(
        ("finish", rid, reason, None if rs is None else len(rs.generated)))
    prompts = _prompts(vocab, 4, 7, seed=4)
    for i, p in enumerate(prompts):
        e.submit(R(rid=i, prompt=p.tolist(), max_new_tokens=5 + i))
    e.step(now=0.0)
    e.step(now=0.0)
    assert e.abort(1, now=0.0)           # running
    assert e.abort(3, now=0.0)           # still queued
    while e.step(now=0.0):
        pass
    return events


def test_sink_order_equals_jax(smoke):
    cfg, qcfg, mcfg, jparams, tp = smoke
    with jd.configured(backend="reference"):
        want = _sink_events(lambda **kw: JEngine(cfg, qcfg, mcfg, jparams,
                                                 **kw), JRequest,
                            cfg.vocab_size)
    got = _sink_events(lambda **kw: _engine(tp, **kw), Request,
                       cfg.vocab_size)
    assert got == want
    finishes = [ev for ev in got if ev[0] == "finish"]
    assert [ev[1:3] for ev in finishes] == [
        (1, "aborted"), (3, "aborted"), (0, "length"), (2, "length")]
    for rid in (0, 2):                   # every token, then one finish
        mine = [ev for ev in got if ev[1] == rid]
        assert [ev[0] for ev in mine] == ["token"] * (5 + rid) + ["finish"]


# ---------------------------------------------------------------------------
# drain_finished and admission fault isolation (tests/test_serving.py)

def test_drain_finished_keeps_run_accounting(smoke):
    tp = smoke[4]
    vocab = get_smoke_config("smollm-135m").vocab_size
    eng = _engine(tp, num_slots=1, max_len=32)
    p = _prompts(vocab, 3, 6, seed=1)
    agg1 = eng.run([Request(rid=0, prompt=p[0].tolist(), max_new_tokens=2)])
    assert agg1["completed"] == 1
    assert [rs.request.rid for rs in eng.drain_finished()] == [0]
    assert eng.completed == [] and eng.finished == [] and eng.aborted == []
    agg2 = eng.run([Request(rid=i, prompt=p[i].tolist(), max_new_tokens=2)
                    for i in (1, 2)])
    assert agg2["completed"] == 2
    assert sorted(m.rid for m in eng.completed) == [1, 2]


def _boom(*a, **k):
    raise RuntimeError("prefill exploded")


def test_admission_failure_fails_only_offending_request(smoke):
    tp = smoke[4]
    vocab = get_smoke_config("smollm-135m").vocab_size
    eng = _engine(tp, num_slots=2, max_len=32)
    events = []
    eng.finish_sink = lambda rid, reason, rs: events.append((rid, reason))
    eng.submit(Request(rid=0, prompt=_prompts(vocab, 1, 8)[0].tolist(),
                       max_new_tokens=4))
    eng.queue.push(Request(rid=1, prompt=[[1, 2], [3]], max_new_tokens=4))
    while eng.queue or eng.scheduler.running:
        eng.step()
    assert eng.admit_failures == 1
    assert (1, "error") in events and (0, "length") in events
    assert len(eng.finished) == 1 and len(eng.finished[0].generated) == 4
    assert eng.scheduler.free_slots == 2


def test_admission_failure_releases_reservation_and_cow_hold(smoke):
    """A prefill that raises after its reservation (here a prefix hit
    holding shared pages and a copy-on-write boundary page) returns every
    page, frees the slot, and leaves the engine serviceable; a
    reservation-time failure (a prompt the chain hash cannot convert)
    archives an "error" state with slot -1."""
    tp = smoke[4]
    vocab = get_smoke_config("smollm-135m").vocab_size
    eng = _engine(tp, num_slots=2, max_len=32, page_size=4)
    baseline = eng.allocator.available
    prompt = _prompts(vocab, 1, 12, seed=11)[0].tolist()   # 3 full pages
    eng.run([Request(rid=0, prompt=list(prompt), max_new_tokens=2)])
    assert eng.allocator.cached == 3 and eng.allocator.in_use == 0
    events = []
    eng.finish_sink = lambda rid, reason, rs: events.append((rid, reason))
    real, eng._prefill_paged = eng._prefill_paged, _boom
    eng.submit(Request(rid=1, prompt=list(prompt), max_new_tokens=4))
    eng.step()
    assert eng.admit_failures == 1 and events == [(1, "error")]
    assert eng.allocator.available == baseline, "reservation leaked"
    assert eng.allocator.in_use == 0 and eng.allocator.cached == 3
    assert eng.scheduler.free_slots == 2 and eng.prefix_hits == 0
    eng._prefill_paged = real
    eng.run([Request(rid=2, prompt=list(prompt), max_new_tokens=2)])
    assert eng.prefix_hits == 1 and eng.prefix_reused_tokens == 11
    assert _by_rid(eng)[2] == _by_rid(eng)[0]
    events.clear()
    eng.queue.push(Request(rid=3, prompt=[[1, 2], [3]], max_new_tokens=2))
    eng.step()
    assert events == [(3, "error")]
    assert eng.aborted[-1].slot == -1
    assert eng.allocator.available == baseline


def test_persistent_admission_failure_trips_the_engine(smoke):
    tp = smoke[4]
    eng = _engine(tp, num_slots=2, max_len=32)
    real, eng._prefill_dense = eng._prefill_dense, _boom
    for i in range(ADMIT_FAIL_TRIP - 1):
        eng.queue.push(Request(rid=i, prompt=[1, 2, 3], max_new_tokens=2))
    eng.step()                           # one below the trip: isolated
    assert eng.admit_failures == ADMIT_FAIL_TRIP - 1
    assert eng.scheduler.free_slots == 2
    eng._prefill_dense = real
    eng.run([Request(rid=100, prompt=[1, 2, 3], max_new_tokens=2)])
    assert eng._admit_fail_streak == 0   # a success resets the streak
    eng._prefill_dense = _boom
    for i in range(ADMIT_FAIL_TRIP):
        eng.queue.push(Request(rid=200 + i, prompt=[1, 2, 3],
                               max_new_tokens=2))
    with pytest.raises(RuntimeError, match="prefill exploded"):
        eng.step()
    assert eng.admit_failures == ADMIT_FAIL_TRIP * 2 - 1


# ---------------------------------------------------------------------------
# metrics and numerics against JAX

@pytest.mark.parametrize("new_tokens,t_first,t_finish", [
    (10, 0.5, 1.0), (1, 0.5, 0.5), (5, 0.25, 1.75), (3, 0.7, 0.7)])
def test_decode_tps_equals_jax(new_tokens, t_first, t_finish):
    from repro.serving.metrics import RequestMetrics as JMetrics
    from repro_torch.serving.metrics import RequestMetrics
    kw = dict(rid=0, slot=0, arrival=0.0, t_admit=0.1,
              t_first_token=t_first, t_finish=t_finish, prompt_len=4,
              new_tokens=new_tokens)
    j, t = JMetrics(**kw), RequestMetrics(**kw)
    assert t.decode_tps == j.decode_tps and t.tpot == j.tpot


def test_tree_code_stats_equals_jax(smoke):
    from repro.obs.numerics import tree_code_stats as j_stats
    from repro_torch.obs.numerics import tree_code_stats
    _, _, _, jparams, tp = smoke
    got, want = tree_code_stats(tp), j_stats(jparams)
    assert got == want and got["elements"] > 0
    assert tree_code_stats({"x": torch.ones(2)}) == {"elements": 0}


def test_numerics_snapshot_equals_jax(smoke):
    cfg, qcfg, mcfg, jparams, tp = smoke
    with jd.configured(backend="reference"):
        je = JEngine(cfg, qcfg, mcfg, jparams, num_slots=2, max_len=16,
                     speculate_k=2, draft_bitwidth=6)
        je._draft_params(6)
        want = je.numerics_snapshot()
    te = _engine(tp, num_slots=2, max_len=16, speculate_k=2,
                 draft_bitwidth=6)
    assert te.numerics_snapshot() == {"weights": want["weights"]}
    te._draft_params(6)                  # a new view re-derives the snapshot
    got = te.numerics_snapshot()
    assert got is te.numerics_snapshot()  # cached until the next view
    assert got["weights"] == want["weights"]
    g, w = got["draft_requant"]["b6"], want["draft_requant"]["b6"]
    assert (g["bits"], g["elements"], g["sat_hi_frac"]) == (
        w["bits"], w["elements"], w["sat_hi_frac"])
    np.testing.assert_allclose(g["rel_err_mean"], w["rel_err_mean"],
                               rtol=1e-6)
