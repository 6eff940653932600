"""Self-speculative decoding and on-demand paging of the port against the
JAX package (smollm smoke config, the same packed weights, CPU).

Tolerances:
* K7 (``ref.requant_pack``) against JAX's Pallas kernel in interpret mode:
  packed words equal (integer arithmetic on both sides).
* Draft views: words equal leaf for leaf; ``draft_requant_error``'s
  ``sat_hi_frac`` equal (an integer count), ``rel_err_mean`` within 1e-6
  (f32 decodes differ by a few ULP across the frameworks, ROADMAP H1,
  and the sums run in another order).
* The autotuner: equal arm sequences and snapshots on one scripted feed.
* Engines: token streams equal. Against the port's own baseline engine
  with greedy and seeded rows mixed (seeded rows replay within the port,
  not JAX's stream, ROADMAP H4); against the JAX engines on greedy
  traces, with the spec and preemption counters equal too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.lns import LNSFormat as JFormat  # noqa: E402
from repro.kernels import dispatch as jd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import spec as jspec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.core.lns import LNSFormat, is_lns_weight  # noqa: E402
from repro_torch.core.quantizer import QuantConfig  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.server.sampling import SamplingParams  # noqa: E402
from repro_torch.serving import Engine, Request, spec, summarize  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from test_torch_model import flat_params, jax_smoke  # noqa: E402


@pytest.fixture(scope="module")
def smoke():
    cfg, qcfg, mcfg, params = jax_smoke()
    tparams = params_from_flat(flat_params(params), LNSFormat(8, 8),
                               device="cpu")
    return cfg, qcfg, mcfg, params, tparams


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _streams(engine):
    return {rs.request.rid: list(rs.generated) for rs in engine.finished}


def _mixed(vocab, n=6, gen=12, seed=3, greedy=False):
    """Greedy and seeded-sampled rows interleaved, varied lengths (as
    tests/test_spec.py builds them); ``greedy`` keeps every row greedy."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sp = None if i % 2 == 0 or greedy else SamplingParams(
            temperature=0.9, top_k=0 if i % 4 == 1 else 8, seed=100 + i)
        prompt = rng.integers(0, vocab, (4 + (i % 3) * 3,)).tolist()
        out.append(Request(rid=i, prompt=prompt,
                           max_new_tokens=gen - (i % 4), sampling=sp))
    return out


def _j_requests(reqs):
    return [JRequest(rid=r.rid, prompt=list(r.prompt),
                     max_new_tokens=r.max_new_tokens) for r in reqs]


def _engine(tparams, **kw):
    return Engine(get_smoke_config("smollm-135m"), QuantConfig.lns_madam(),
                  tparams, device="cpu", **kw)


# ---------------------------------------------------------------------------
# K7


@pytest.mark.parametrize("src,dst", [((8, 8), 6), ((8, 8), 7), ((8, 8), 8),
                                     ((6, 2), 8)])
def test_k7_requant_words_equal_jax_pallas(smoke, src, dst):
    """8->6, 8->7, 8->8 (identity) and the 6->8 upscale, on the smoke
    leaves (8-bit sources) and on random words over the whole byte range
    at shapes that are not multiples of 256."""
    jsrc, tsrc = JFormat(*src), LNSFormat(*src)
    jdst, tdst = jsrc.with_bits(dst), tsrc.with_bits(dst)
    assert (tdst.bits, tdst.gamma) == (jdst.bits, jdst.gamma)
    rng = np.random.default_rng(dst)
    words = [rng.integers(0, 256, shape, dtype=np.uint8)
             for shape in ((37, 300), (3, 5, 70), (260, 9))]
    if src == (8, 8):
        words += [np.array(leaf.packed) for leaf in jax.tree.leaves(
            smoke[3], is_leaf=lambda x: hasattr(x, "packed"))
            if hasattr(leaf, "packed")]
    for w in words:
        want = np.asarray(jops.requant_pack(jax.numpy.asarray(w), jsrc, jdst,
                                            interpret=True))
        got = dispatch.requant_pack(torch.from_numpy(w), tsrc, tdst)
        assert got.dtype == torch.uint8 and tuple(got.shape) == w.shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert ops.launch_counts()["requant_pack"] == 0


@pytest.mark.parametrize("dst", [6, 7])
def test_k7_many_leaves_equal_one_at_a_time_and_jax_pallas(smoke, dst):
    """``requant_pack_many`` over every packed leaf of the smoke config
    (one K7 launch on the card) gives the words of one leaf at a time and
    of JAX's Pallas kernel in interpret mode, leaf for leaf."""
    jparams, tparams = smoke[3], smoke[4]
    src = LNSFormat(8, 8)
    tl = [leaf.packed for _, leaf in leaves(tparams) if is_lns_weight(leaf)]
    jl = [leaf.packed for leaf in jax.tree.leaves(
        jparams, is_leaf=lambda x: hasattr(x, "packed"))
        if hasattr(leaf, "packed")]
    assert len(tl) == len(jl) == 8
    many = dispatch.requant_pack_many(tl, src, src.with_bits(dst))
    # one format a leaf is accepted where they agree
    again = dispatch.requant_pack_many(tl, [src] * 8,
                                       [src.with_bits(dst)] * 8)
    for w, jw, m, a in zip(tl, jl, many, again):
        one = dispatch.requant_pack(w, src, src.with_bits(dst))
        want = np.asarray(jops.requant_pack(jw, JFormat(8, 8),
                                            JFormat(8, 8).with_bits(dst),
                                            interpret=True))
        assert m.dtype == torch.uint8 and m.shape == w.shape
        np.testing.assert_array_equal(m.numpy(), one.numpy())
        np.testing.assert_array_equal(m.numpy(), want)
        np.testing.assert_array_equal(a.numpy(), want)
    assert ops.launch_counts()["requant_pack"] == 0


def _count_grouped_calls(monkeypatch):
    calls = []
    many = dispatch.requant_pack_many

    def record(packed, src, dst):
        calls.append((len(packed), src, dst))
        return many(packed, src, dst)

    monkeypatch.setattr(dispatch, "requant_pack_many", record)
    return calls


@pytest.mark.parametrize("bits", [6, 7, 8])
def test_draft_view_is_one_grouped_call(smoke, monkeypatch, bits):
    """``build_draft_params`` groups the LNS leaves by (src, dst) and
    makes one ``dispatch.requant_pack_many`` call a group: the smoke
    config's 8 leaves share (8, 8), so one call (none at the serving
    width)."""
    calls = _count_grouped_calls(monkeypatch)
    view = spec.build_draft_params(smoke[4], bits)
    src = LNSFormat(8, 8)
    assert calls == ([] if bits == 8 else [(8, src, src.with_bits(bits))])
    assert (view is smoke[4]) == (bits == 8)


def test_draft_view_groups_by_format(smoke, monkeypatch):
    """Leaves of two formats make two calls; a group of more than
    ``ops.K7_MAX_LEAVES`` leaves takes one call per that many; the words
    equal the one-leaf plain version either way."""
    from repro_torch.core.lns import LNSWeight
    tparams = smoke[4]
    lns = [(p, w) for p, w in leaves(tparams) if is_lns_weight(w)]
    tree = {f"a{i}": w for i, (_, w) in enumerate(lns)}
    six = LNSFormat(8, 16)
    tree.update({f"b{i}": LNSWeight(w.packed, w.scale, six)
                 for i, (_, w) in enumerate(lns)})
    tree.update({f"c{i}": w for i, (_, w) in enumerate(lns * 2)})
    calls = _count_grouped_calls(monkeypatch)
    view = spec.build_draft_params(tree, 6)
    src = LNSFormat(8, 8)
    assert sorted(calls, key=lambda c: (c[1].gamma, -c[0])) == [
        (16, src, src.with_bits(6)), (8, src, src.with_bits(6)),
        (8, six, six.with_bits(6))]
    for name, leaf in tree.items():
        want = dispatch.requant_pack(leaf.packed, leaf.fmt,
                                     leaf.fmt.with_bits(6))
        assert view[name].fmt == leaf.fmt.with_bits(6)
        assert view[name].scale is leaf.scale
        np.testing.assert_array_equal(view[name].packed.numpy(),
                                      want.numpy())


# ---------------------------------------------------------------------------
# draft views


@pytest.mark.parametrize("bits", [6, 7, 8])
def test_draft_params_equal_jax(smoke, bits):
    _, _, _, jparams, tparams = smoke
    with jd.configured(backend="reference"):
        jview = jspec.build_draft_params(jparams, bits)
        jerr = jspec.draft_requant_error(jparams, jview)
    jflat = flat_params(jview)
    view = spec.build_draft_params(tparams, bits)
    if bits == 8:
        assert view is tparams  # the identity arm is the serving tree
    n = 0
    for (path, leaf), (_, src) in zip(leaves(view), leaves(tparams)):
        if not is_lns_weight(leaf):
            assert leaf is src
            continue
        assert leaf.scale is src.scale  # shared by reference
        assert leaf.fmt == src.fmt.with_bits(bits)
        np.testing.assert_array_equal(
            leaf.packed.numpy(), jflat["::".join(path) + "::packed"])
        n += 1
    assert n == 8
    err = spec.draft_requant_error(tparams, view)
    assert err["bits"] == jerr["bits"] == bits
    assert err["elements"] == jerr["elements"]
    assert err["sat_hi_frac"] == jerr["sat_hi_frac"]
    assert err["rel_err_mean"] == pytest.approx(jerr["rel_err_mean"],
                                                abs=1e-6)
    if bits < 8:
        assert err["rel_err_mean"] > 0


# ---------------------------------------------------------------------------
# config and autotuner


def test_spec_config_validation_and_arms():
    for bad in (dict(k=0), dict(draft_bits=1), dict(draft_bits=9)):
        with pytest.raises(ValueError):
            spec.SpecConfig(**bad)
        with pytest.raises(ValueError):
            jspec.SpecConfig(**bad)
    arms = spec.SpecConfig(draft_bits=7, k=4).arms()
    assert arms[0] == (7, 4)
    assert len(arms) == len(set(arms)) == 9
    assert arms == jspec.SpecConfig(draft_bits=7, k=4).arms()
    assert spec.spec_supported(get_smoke_config("smollm-135m")) is None


def test_autotuner_decisions_equal_jax():
    """One scripted feed of observe() calls: the same proposals and the
    same snapshot (the tuner draws no random numbers)."""
    kw = dict(draft_bits=6, k=2, autotune=True, decide_every=2)
    tuners = (spec.SpecAutotuner(spec.SpecConfig(**kw)),
              jspec.SpecAutotuner(jspec.SpecConfig(**kw)))
    rng = np.random.default_rng(0)
    feed = [(int(rng.integers(1, 9)), float(rng.uniform(0.01, 0.05)),
             {"greedy": (int(rng.integers(0, 5)), 4),
              "sampled": (int(rng.integers(0, 3)), 4)})
            for _ in range(80)]
    seqs = []
    for tuner in tuners:
        seq = []
        for emitted, wall, per_class in feed:
            arm = tuner.propose()
            seq.append(arm)
            tuner.observe(arm, emitted, wall, per_class)
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert set(seqs[0]) == set(tuners[0].arms)
    assert tuners[0].snapshot() == tuners[1].snapshot()


# ---------------------------------------------------------------------------
# the spec engine against the port's own baseline


@pytest.mark.parametrize("kw,k,bits", [
    (dict(), 3, 7),
    (dict(page_size=8, num_pages=18), 3, 6),
    (dict(page_size=8, num_pages=18, alloc_policy="ondemand"), 3, 6),
    (dict(page_size=8, num_pages=18, alloc_policy="ondemand"), 1, 6),
], ids=["dense-k3-b7", "reserve-k3-b6", "ondemand-k3-b6", "ondemand-k1-b6"])
def test_spec_streams_equal_baseline(smoke, kw, k, bits):
    """Greedy and seeded rows mixed. At k=1 the verify is the baseline's
    own S=1 step, which isolates the cursor rewind, the sampler's
    step_offset and the KV overwrite from any batching difference."""
    tparams = smoke[4]
    vocab = get_smoke_config("smollm-135m").vocab_size
    base = _engine(tparams, num_slots=3, max_len=48, **kw)
    base.run(_mixed(vocab))
    eng = _engine(tparams, num_slots=3, max_len=48, speculate_k=k,
                  draft_bitwidth=bits, **kw)
    agg = eng.run(_mixed(vocab))
    assert _streams(eng) == _streams(base)
    assert len(_streams(eng)) == 6
    assert eng.spec_cycles > 0
    # every token after the prefill's comes from a cycle or a fallback
    after_first = sum(len(s) - 1 for s in _streams(eng).values())
    assert eng.spec_emitted <= after_first
    assert eng.spec_fallbacks or eng.spec_emitted == after_first
    assert 0 < agg["spec_drafted_tokens"] == eng.spec_drafted
    assert agg["spec_accepted_tokens"] == eng.spec_accepted
    assert base.spec_snapshot() is None
    assert summarize(base.completed, 1.0)["spec_drafted_tokens"] == 0
    if k == 1:
        assert eng.spec_drafted == eng.spec_emitted
    if eng.page_size:
        assert eng.allocator.available == eng.num_pages
        assert eng.allocator.in_use == 0


def test_spec_autotune_streams_equal_baseline(smoke):
    """Arm switches (bits and k) never change what is emitted."""
    tparams = smoke[4]
    vocab = get_smoke_config("smollm-135m").vocab_size
    base = _engine(tparams, num_slots=2, max_len=40)
    base.run(_mixed(vocab, n=4, gen=10))
    eng = _engine(tparams, num_slots=2, max_len=40, speculate_k=2,
                  draft_bitwidth=8, spec_autotune=True)
    eng.run(_mixed(vocab, n=4, gen=10))
    assert _streams(eng) == _streams(base)
    snap = eng.spec_snapshot()
    assert snap["spec_cycles"] > 0 and "spec_tuner_cycles" in snap


# ---------------------------------------------------------------------------
# against the JAX engines


def _j_engine(smoke, **kw):
    cfg, qcfg, mcfg, jparams, _ = smoke
    return JEngine(cfg, qcfg, mcfg, jparams, prefix_cache=False, **kw)


SPEC_COUNTERS = ("spec_cycles", "spec_drafted", "spec_accepted",
                 "spec_fallbacks", "spec_emitted", "decode_steps")


@pytest.mark.parametrize("kw", [
    dict(num_slots=3, max_len=48),
    dict(num_slots=3, max_len=48, page_size=8, num_pages=18,
         alloc_policy="ondemand"),
], ids=["dense", "ondemand"])
def test_spec_engine_equals_jax_greedy(smoke, kw):
    vocab = get_smoke_config("smollm-135m").vocab_size
    reqs = _mixed(vocab, greedy=True)
    spec_kw = dict(speculate_k=3, draft_bitwidth=6)
    with jd.configured(backend="reference"):
        jeng = _j_engine(smoke, **kw, **spec_kw)
        jeng.run(_j_requests(reqs))
    eng = _engine(smoke[4], prefix_cache=False, **kw, **spec_kw)
    eng.run(reqs)
    assert _streams(eng) == _streams(jeng)
    for c in SPEC_COUNTERS:
        assert getattr(eng, c) == getattr(jeng, c), c
    if eng.page_size:
        assert eng.allocator.available == jeng.allocator.available == 18
        assert eng.spec_pages_trimmed == jeng.spec_pages_trimmed


# a pool of 6 pages of 4 tokens under 3 slots: each request fits alone
# (<= 5 pages), three together do not
PREEMPT = dict(num_slots=3, max_len=40, page_size=4, num_pages=6,
               alloc_policy="ondemand")


@pytest.mark.parametrize("k", [0, 3])
def test_ondemand_preemption_equals_jax(smoke, k):
    vocab = get_smoke_config("smollm-135m").vocab_size
    reqs = _mixed(vocab, n=5, gen=14, greedy=True)
    spec_kw = dict(speculate_k=k, draft_bitwidth=7) if k else {}
    with jd.configured(backend="reference"):
        jeng = _j_engine(smoke, **PREEMPT, **spec_kw)
        jeng.run(_j_requests(reqs))
    eng = _engine(smoke[4], prefix_cache=False, **PREEMPT, **spec_kw)
    agg = eng.run(reqs)
    assert agg["completed"] == 5
    assert _streams(eng) == _streams(jeng)
    assert eng.preemptions == jeng.preemptions > 0
    assert agg["preemptions"] == eng.preemptions
    assert eng.decode_page_allocs == jeng.decode_page_allocs
    for c in SPEC_COUNTERS:
        assert getattr(eng, c) == getattr(jeng, c), c
    assert eng.allocator.available == eng.num_pages
    assert eng.allocator.in_use == 0 and not eng._preempted
    # a preempted request resumes to the same stream as an engine whose
    # pool never runs dry
    roomy = _engine(smoke[4], prefix_cache=False,
                    **dict(PREEMPT, num_pages=30), **spec_kw)
    roomy.run(reqs)
    assert roomy.preemptions == 0
    assert _streams(roomy) == _streams(eng)


def test_abort_mid_flight_returns_pages(smoke):
    eng = _engine(smoke[4], num_slots=3, max_len=48, page_size=8,
                  num_pages=18, alloc_policy="ondemand", speculate_k=3,
                  draft_bitwidth=6)
    vocab = get_smoke_config("smollm-135m").vocab_size
    for r in _mixed(vocab, n=4, gen=24):
        eng.submit(r)
    for _ in range(3):  # admissions and a spec cycle or two
        eng.step()
    assert eng.allocator.available < 18 and len(eng.queue) == 1
    for rid in (0, 1, 3):  # two running, one queued
        assert eng.abort(rid)
    assert not eng.abort(99)
    while eng.step():
        pass
    assert eng.allocator.available == 18 and eng.allocator.in_use == 0
    assert sorted(rs.request.rid for rs in eng.aborted) == [0, 1]
    assert [rs.request.rid for rs in eng.finished] == [2]
    assert all(rs.aborted for rs in eng.aborted)


# ---------------------------------------------------------------------------
# ROADMAP H20: the paged write's duplicate targets


class _ReversedScatter(TorchDispatchMode):
    """Applies every non-accumulating ``index_put_`` with its updates in
    reverse order: where two updates hit one element, the first one now
    wins. A card's scatter applies duplicate targets in no fixed order,
    so this is one order the card may take; a write that gives every
    element one update at most is unchanged by it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.ops.aten.index_put_.default,
                    torch.ops.aten.index_put.default):
            acc = args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                           False)
            idx = list(args[1])
            if not acc and idx and all(i is not None and i.dtype != torch.bool
                                       for i in idx):
                bi = torch.broadcast_tensors(*idx)
                n, lead = bi[0].numel(), tuple(bi[0].shape)
                tail = tuple(args[0].shape[len(idx):])
                vals = args[2].expand(lead + tail).reshape((n,) + tail)
                return func(args[0], [i.reshape(n).flip(0) for i in bi],
                            vals.flip(0), *args[3:], **kwargs)
        return func(*args, **kwargs)


def _pools(eng):
    """Every paged pool of the engine (words and any scales), null page
    included, as numpy arrays."""
    out = {}
    for path, t in leaves(eng.caches):
        if path[-1] in ("kp", "vp", "kp_scale", "vp_scale"):
            out[path] = t.to(torch.float32).numpy().copy()
    return out


@pytest.mark.parametrize("k", [0, 4])
def test_paged_writes_do_not_depend_on_scatter_order(smoke, k):
    """H20: on demand, idle rows and prefill pads write through block
    tables that point at the one null page, several to the same slot of
    it in one call. The pools, null page included, and the streams must
    be the same whatever order the scatter applies duplicate targets in,
    as they are on four cards whose data replicas must agree (25c of
    ``chip_smoke.py --mesh``): each target takes the last writer of the
    call in row-major order, the order of the CPU's scatter and of the
    JAX package's ``.at[].set`` on the CPU."""
    vocab = get_smoke_config("smollm-135m").vocab_size
    reqs = _mixed(vocab, n=5, gen=14)
    kw = dict(num_slots=3, max_len=40, page_size=4, num_pages=12,
              alloc_policy="ondemand", prefix_cache=False)
    if k:
        kw.update(speculate_k=k, draft_bitwidth=6)
    plain = _engine(smoke[4], **kw)
    plain.run(reqs)
    with _ReversedScatter():
        rev = _engine(smoke[4], **kw)
        rev.run(reqs)
    assert _streams(rev) == _streams(plain)
    a, b = _pools(plain), _pools(rev)
    assert a.keys() == b.keys() and a
    for key in a:
        np.testing.assert_array_equal(b[key], a[key], err_msg=str(key))
