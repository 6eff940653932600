"""The modality stubs of the port (phi-3-vision-4.2b's patch prefix,
musicgen-medium's four codebooks) against the JAX package at each
config's ``SMOKE`` shape, on the CPU, with JAX parameters carried across
by ``convert.params_from_flat`` and inputs drawn from numpy seeds.

Tolerances:
* Configs, ``params_count()``, the stubs' shapes and dtypes, the delay
  pattern, ``SyntheticLM`` batches, carried leaves: equal.
* Forward logits and ``lm_loss`` with no quantizer (``qcfg=None``, f32
  dense weights, every zero-initialized gain replaced by a random value):
  2e-5 absolute on the logits and 1e-5 relative on the loss, as
  ``test_torch_dense_variants.py`` (f32 rsqrt, exp and sum orders differ
  by ULPs across the frameworks).
* The codebook embedding sum: bit-equal at f32 and at bf16 (the port
  pins JAX's order on the CPU: the K rows summed in f32, rounded once).
* ``decode_step`` against ``forward``: 2e-5 absolute.
* One train step: under ``full_precision`` quantizers the packed words
  are equal (the tie band of H6 holds no word at step 1 here) and the
  loss and grad norm within 1e-5 relative; under ``lns8`` the rule of
  ``test_torch_train.py`` for lns8 steps: loss within 1e-3 relative,
  grad norm 10%, at most 2% of the words differing. The 8-bit forward
  flips a Q_A code where an ulp of log2 sits on a rounding tie (H1):
  phi-3-vision's first batch has such a flip (patch positions and the
  first two text positions bit-equal, logits 0.022 apart after it, the
  loss 1.16e-4 relative; measured), four of its next five batches agree
  to 1.2e-7 on every logit.
* Engine streams (f32 smoke configs, greedy): equal to JAX's engine, with
  and without the prefix cache, and the prefix registry's page ids
  equal. Codebook greedy sampling equals JAX's; seeded codebooks draw
  pairwise different noise and replay within the port (H4: not JAX's
  stream).
"""
import asyncio
import dataclasses
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.core.lns import LNSFormat as JFormat  # noqa: E402
from repro.core.quantizer import QuantConfig as JQuantConfig  # noqa: E402
from repro.kernels import dispatch as jd  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import stubs as jstubs  # noqa: E402
from repro.models.common import ArchConfig as JArchConfig  # noqa: E402
from repro.optim.madam import MadamConfig as JMadamConfig  # noqa: E402
from repro.training import init_train_state as j_init_train_state  # noqa: E402
from repro.training.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro_torch.checkpoint.manager import flatten_state  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.core.lns import LNSFormat, lns_weight_encode  # noqa: E402
from repro_torch.core.quantizer import QuantConfig  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import stubs  # noqa: E402
from repro_torch.models.layers import embed_lookup  # noqa: E402
from repro_torch.optim.madam import MadamConfig  # noqa: E402
from repro_torch.server.sampling import (SamplingParams,  # noqa: E402
                                         codebook_seed, sample_logits,
                                         sampling_rows, set_row)
from repro_torch.training.data import SyntheticLM  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

from test_torch_dense_variants import _perturbed_dense, _unflat  # noqa: E402
from test_torch_model import flat_params  # noqa: E402

MODALITY = ["phi-3-vision-4.2b", "musicgen-medium"]
FMT8 = LNSFormat(8, 8)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jparams(jcfg, seed=11):
    """JAX's dense f32 parameters of ``jcfg`` with perturbed gains, as a
    JAX tree and as the ``::``-keyed numpy leaves."""
    flat = _perturbed_dense(jcfg, seed=seed)
    tree = _unflat(flat, jax.eval_shape(
        lambda: jm.init_params(jax.random.PRNGKey(0), jcfg)))
    return tree, flat


def _batch(arch, batch=2, seq=8, cursor=0):
    """JAX's ``SyntheticLM`` batch of the smoke config (numpy)."""
    return JSyntheticLM(j_smoke_config(arch), batch=batch,
                        seq=seq).batch_at(cursor)


# ---------------------------------------------------------------------------
# configs, stubs, conversion, data


@pytest.mark.parametrize("arch", MODALITY)
def test_configs_and_params_count_match_jax(arch):
    """Field for field as JAX's (a JAX field the port does not carry
    sits at JAX's default), the same family, layer pattern and
    parameter count at full width and at the smoke shape; the count is
    the port's drawn tree's too (K * V embedding rows and head
    columns)."""
    assert arch in ARCHS
    tf = {f.name for f in dataclasses.fields(get_config(arch))}
    assert {"num_patches", "num_codebooks"} <= tf
    for t, j in ((get_config(arch), j_config(arch)),
                 (get_smoke_config(arch), j_smoke_config(arch))):
        for f in dataclasses.fields(JArchConfig):
            if f.name in tf:
                assert getattr(t, f.name) == getattr(j, f.name), f.name
            else:
                assert getattr(j, f.name) == f.default, f.name
        assert t.layer_pattern() == j.layer_pattern() == ((), t.num_layers,
                                                          ("dense",))
        assert t.params_count() == j.params_count()
    cfg = get_smoke_config(arch)
    tree = tm.init_params(cfg, seed=0, device="cpu")
    assert sum(x.numel() for _, x in leaves(tree)) == cfg.params_count()
    rows = cfg.vocab_size * (cfg.num_codebooks or 1)
    assert tuple(tree["embed"]["tok"].shape) == (rows, cfg.d_model)
    assert tuple(tree["embed"]["head"].shape) == (cfg.d_model, rows)


def test_stub_shapes_and_delay_pattern_match_jax():
    """The stubs' shapes and dtypes at full width and the smoke shape;
    ``apply_delay_pattern`` bit for bit on the same tokens."""
    gen = torch.Generator().manual_seed(0)
    for get, jget in ((get_config, j_config),
                      (get_smoke_config, j_smoke_config)):
        cfg, jcfg = get("phi-3-vision-4.2b"), jget("phi-3-vision-4.2b")
        p = stubs.vision_patches_stub(gen, 2, cfg)
        jp = jstubs.vision_patches_stub(jax.random.PRNGKey(0), 2, jcfg)
        assert tuple(p.shape) == jp.shape
        assert str(p.dtype).split(".")[-1] == str(jp.dtype)
        cfg, jcfg = get("musicgen-medium"), jget("musicgen-medium")
        t = stubs.encodec_tokens_stub(gen, 2, 9, cfg)
        jt = jstubs.encodec_tokens_stub(jax.random.PRNGKey(0), 2, 9, jcfg)
        assert tuple(t.shape) == jt.shape and t.dtype == torch.int32
        assert str(jt.dtype) == "int32"
        assert 0 <= int(t.min()) and int(t.max()) < cfg.vocab_size
    rng = np.random.default_rng(3)
    for shape, pad in (((2, 9, 4), 0), ((3, 4, 4), 5), ((1, 5, 2), 1)):
        x = rng.integers(0, 64, shape).astype(np.int32)
        want = np.asarray(jstubs.apply_delay_pattern(jnp.asarray(x), pad))
        got = stubs.apply_delay_pattern(torch.from_numpy(x), pad).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", MODALITY)
def test_convert_carries_every_leaf(arch):
    """JAX's dense tree and its packed 8-bit serving tree carried across:
    the same leaves, shapes and values (the (K * V)-row table and head
    included)."""
    jcfg = j_smoke_config(arch)
    _, flat = _jparams(jcfg)
    tp = params_from_flat(flat, FMT8, device="cpu")
    back = flatten_state(tp)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    jmcfg = JMadamConfig(update_format=JFormat(bits=8, gamma=8))
    packed = flat_params(jax.jit(lambda k: j_init_train_state(
        k, jcfg, jmcfg).params)(jax.random.PRNGKey(0)))
    back = flatten_state(params_from_flat(packed, FMT8, device="cpu"))
    assert sorted(back) == sorted(packed)
    for k in packed:
        np.testing.assert_array_equal(back[k].astype(np.int64),
                                      packed[k].astype(np.int64), err_msg=k)
    rows = jcfg.vocab_size * (jcfg.num_codebooks or 1)
    assert packed["embed::tok::packed"].shape[0] == rows
    assert packed["embed::head::packed"].shape[1] == rows


@pytest.mark.parametrize("arch", MODALITY)
def test_synthetic_lm_batches_equal_jax(arch):
    """Codebook tokens (B, S, K) and f32 patches, byte for byte."""
    cfg = get_smoke_config(arch)
    for cursor in (0, 1, 777):
        a = JSyntheticLM(j_smoke_config(arch), batch=3, seq=7,
                         seed=4).batch_at(cursor)
        b = SyntheticLM(cfg, batch=3, seq=7, seed=4).batch_at(cursor)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k
    b = SyntheticLM(cfg, batch=3, seq=7).batch_at(0)
    if cfg.num_codebooks:
        assert b["tokens"].shape == (3, 7, cfg.num_codebooks)
        assert "patches" not in b
    else:
        assert b["patches"].shape == (3, cfg.num_patches, cfg.d_model)


# ---------------------------------------------------------------------------
# forward, loss, embedding, decode


def _both_inputs(arch, batch=2, seq=8):
    b = _batch(arch, batch, seq)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    return jb, tb


@pytest.mark.parametrize("arch", MODALITY)
def test_forward_logits_match_jax(arch):
    """phi-3-vision: 8 patches + 8 text positions, logits over all 16;
    musicgen: (B, S, 4) tokens, logits (B, S, 4 * V)."""
    jcfg, tcfg = j_smoke_config(arch), get_smoke_config(arch)
    jparams, flat = _jparams(jcfg)
    tp = params_from_flat(flat, FMT8, device="cpu")
    jb, tb = _both_inputs(arch)
    jl = np.asarray(jax.jit(lambda p, b: jm.forward(
        p, b["tokens"], jcfg, None, patches=b.get("patches")).logits)(
        jparams, jb))
    tl = tm.forward(tp, tb["tokens"], tcfg, None,
                    patches=tb.get("patches")).numpy()
    n_pos = 8 + tcfg.num_patches
    width = tcfg.vocab_size * (tcfg.num_codebooks or 1)
    assert tl.shape == jl.shape == (2, n_pos, width)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-5)


@pytest.mark.parametrize("arch", MODALITY)
def test_lm_loss_on_text_positions_matches_jax(arch):
    """The loss against JAX's, and against the cross entropy of the
    port's own forward over the text positions only (phi-3-vision's
    patch positions are run and dropped; musicgen's logits read as
    (B, S, K, V))."""
    jcfg, tcfg = j_smoke_config(arch), get_smoke_config(arch)
    jparams, flat = _jparams(jcfg)
    tp = params_from_flat(flat, FMT8, device="cpu")
    jb, tb = _both_inputs(arch)
    jl = float(jax.jit(lambda p, b: jm.lm_loss(p, b, jcfg, None,
                                                remat=False))(jparams, jb))
    tl = float(tm.lm_loss(tp, tb, tcfg, None))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    logits = tm.forward(tp, tb["tokens"], tcfg, None,
                        patches=tb.get("patches"))
    text = logits[:, tcfg.num_patches:].reshape(
        tuple(tb["labels"].shape) + (tcfg.vocab_size,))
    want = torch.nn.functional.cross_entropy(
        text.reshape(-1, tcfg.vocab_size), tb["labels"].reshape(-1).long())
    np.testing.assert_allclose(tl, float(want), rtol=1e-6)
    if tcfg.num_patches:
        # the patches reach the text through attention: other patches,
        # another loss
        tb2 = dict(tb, patches=tb["patches"] + 1.0)
        assert float(tm.lm_loss(tp, tb2, tcfg, None)) != tl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codebook_embedding_sum_matches_jax(dtype):
    """musicgen's K rows a position at offsets k * V, summed: bit-equal
    to JAX's ``_embed`` at f32 and bf16, and a packed table's lookup
    equals the lookup in its decoded table."""
    jcfg = dataclasses.replace(j_smoke_config("musicgen-medium"),
                               dtype=dtype, d_model=128)
    tcfg = dataclasses.replace(get_smoke_config("musicgen-medium"),
                               dtype=dtype, d_model=128)
    rng = np.random.default_rng(7)
    rows = tcfg.vocab_size * tcfg.num_codebooks
    table = rng.standard_normal((rows, 128)).astype(np.float32)
    tokens = rng.integers(0, tcfg.vocab_size, (3, 11, 4)).astype(np.int32)
    jt = jnp.asarray(table).astype(jcfg.compute_dtype)
    want = np.asarray(jax.jit(lambda t, x: jm._embed(
        {"embed": {"tok": t}}, x, jcfg, None))(jt, jnp.asarray(tokens))
        .astype(jnp.float32))
    tt = torch.from_numpy(table).to(tcfg.compute_dtype)
    got = embed_lookup(tt, torch.from_numpy(tokens), tcfg)
    assert got.dtype == tcfg.compute_dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    packed = lns_weight_encode(torch.from_numpy(table), FMT8)
    dec = packed.decode(tcfg.compute_dtype)
    assert torch.equal(embed_lookup(packed, torch.from_numpy(tokens), tcfg),
                       embed_lookup(dec, torch.from_numpy(tokens), tcfg))


def test_musicgen_decode_equals_forward():
    """(B, S, 4) tokens appended 1 and 3 positions at a time through a
    dense and a paged cache equal the training forward."""
    cfg = get_smoke_config("musicgen-medium")
    p = tm.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(_batch("musicgen-medium", 2, 12)["tokens"])
    want = tm.forward(p, tokens, cfg, None)
    for page in (None, 4):
        for chunk in (1, 3):
            caches = tm.init_caches(2, 16, cfg, page_size=page, device="cpu")
            bt = (torch.arange(8, dtype=torch.int32).reshape(2, 4)
                  if page else None)
            got = [tm.forward(p, tokens[:, t:t + chunk], cfg, None,
                              caches=caches, pos_offset=t, block_tables=bt)
                   for t in range(0, 12, chunk)]
            np.testing.assert_allclose(torch.cat(got, 1).numpy(),
                                       want.numpy(), rtol=0, atol=2e-5)


def test_flash_attention_takes_a_ragged_last_block():
    """phi-3-vision's patches plus its text need not tile by the KV block
    (576 + 64 = 640 against 512): the port ends in a shorter block, equal
    to one block over the whole length and to JAX's flash attention at a
    block that tiles (JAX asserts that the block divides the length,
    ROADMAP H15)."""
    from repro.models.attention import flash_attention as j_flash
    from repro_torch.models.attention import flash_attention
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 10, 4, 16)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    ragged = flash_attention(tq, tk, tv, block_k=4)          # 4 + 4 + 2
    whole = flash_attention(tq, tk, tv, block_k=10)
    np.testing.assert_allclose(ragged.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_k=5))
    np.testing.assert_allclose(ragged.numpy(), want, rtol=0, atol=1e-6)
    with pytest.raises(AssertionError):
        j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_k=4)


# ---------------------------------------------------------------------------
# one train step


@pytest.mark.parametrize("qname", ["fp32", "lns8"])
@pytest.mark.parametrize("arch", MODALITY)
def test_train_step_matches_jax(arch, qname):
    from repro.training import build_train_step as j_build
    from repro_torch.convert import train_state_from_flat
    from repro_torch.training.steps import build_train_step
    jq, tq = {"fp32": (JQuantConfig.full_precision(),
                       QuantConfig.full_precision()),
              "lns8": (JQuantConfig.lns_madam(),
                       QuantConfig.lns_madam())}[qname]
    jcfg, tcfg = j_smoke_config(arch), get_smoke_config(arch)
    jmcfg = JMadamConfig()
    js = jax.jit(lambda k: j_init_train_state(k, jcfg, jmcfg))(
        jax.random.PRNGKey(0))
    ts = train_state_from_flat(flat_params(js), MadamConfig(), device="cpu")
    b = _batch(arch, batch=2, seq=16)
    with jd.configured(backend="reference"):
        jstep = jax.jit(j_build(jcfg, jq, jmcfg))
    js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    ts, tmet = build_train_step(tcfg, tq, MadamConfig())(ts, b)
    rtol = 1e-5 if qname == "fp32" else 1e-3
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=rtol)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]),
                               rtol=1e-5 if qname == "fp32" else 0.1)
    jf, tf = flat_params(js.params), flatten_state(ts.params)
    assert set(jf) == set(tf)
    n = tot = 0
    for k in jf:
        if k.endswith("packed"):
            n += int(np.sum(jf[k].astype(np.int64) != tf[k].astype(np.int64)))
            tot += jf[k].size
    if qname == "fp32":
        assert n == 0, (n, tot)
    else:
        assert n <= 0.02 * tot, (n, tot)


# ---------------------------------------------------------------------------
# sampling


def test_codebook_greedy_sampling_matches_jax():
    from repro.server.sampling import sample_logits as j_sample
    from repro.server.sampling import sampling_rows as j_rows
    k, v, b = 4, 48, 3
    lg = np.random.default_rng(6).normal(size=(b, k * v)).astype(np.float32)
    want = np.asarray(j_sample(jnp.asarray(lg), {
        n: jnp.asarray(x) for n, x in j_rows(b).items()},
        num_codebooks=k, vocab_size=v))
    got = sample_logits(torch.from_numpy(lg), sampling_rows(b),
                        num_codebooks=k, vocab_size=v).numpy()
    assert got.shape == want.shape == (b, k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, lg.reshape(b, k, v).argmax(-1))


def test_codebook_seeded_noise_distinct_and_replayable():
    """Each codebook of a seeded row draws with ``codebook_seed(seed,
    k)``: four pairwise different noise rows, the tokens those noises
    give, the same tokens on a repeat and whichever rows share the batch;
    a greedy neighbour stays the argmax; top-k rows take the sort path."""
    k, v = 4, 64
    rng = np.random.default_rng(2)
    lg = torch.from_numpy(rng.normal(size=(3, k * v)).astype(np.float32))
    rows = sampling_rows(3)
    set_row(rows, 1, SamplingParams(temperature=0.7, seed=42))
    rows["step"][:] = [0, 5, 0]
    got = sample_logits(lg, rows, num_codebooks=k, vocab_size=v)
    assert torch.equal(got, sample_logits(lg, rows, num_codebooks=k,
                                          vocab_size=v))
    seeds = codebook_seed(np.full(k, 42), np.arange(k))
    assert seeds[0] == 42 and len(set(seeds.tolist())) == k
    noise = ref.gumbel_noise(seeds, np.full(k, 5), v)
    for a in range(k):
        for c in range(a + 1, k):
            assert not torch.equal(noise[a], noise[c])
    want = torch.argmax(lg[1].reshape(k, v) / 0.7 + noise, dim=-1)
    assert torch.equal(got[1].long(), want)
    assert torch.equal(got[0].long(), lg[0].reshape(k, v).argmax(-1))
    alone = {n: x[1:2] for n, x in rows.items()}
    assert torch.equal(sample_logits(lg[1:2], alone, num_codebooks=k,
                                     vocab_size=v)[0], got[1])
    set_row(rows, 2, SamplingParams(temperature=0.9, top_k=5, seed=7))
    out = sample_logits(lg, rows, num_codebooks=k, vocab_size=v)
    assert out.shape == (3, k)
    assert torch.equal(out[1], got[1])
    top5 = torch.topk(lg[2].reshape(k, v), 5, dim=-1).indices
    assert all(int(out[2, j]) in top5[j].tolist() for j in range(k))


# ---------------------------------------------------------------------------
# serving: against JAX's engine


def _shared_requests(cfg, n=4, seed=3):
    """Prompts sharing an 8-position prefix (two pages of 4), each with
    its own 2-5-position suffix; greedy."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    width = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    prefix = rng.integers(0, cfg.vocab_size, (8,) + width)
    out = []
    for i in range(n):
        suffix = rng.integers(0, cfg.vocab_size, (2 + i,) + width)
        out.append(Request(rid=i, prompt=np.concatenate([prefix, suffix])
                           .astype(np.int32).tolist(),
                           max_new_tokens=6 - (i % 2)))
    return out


def _streams(e):
    return {rs.request.rid: rs.generated for rs in e.finished}


@pytest.fixture(scope="module")
def packed_draws():
    """Each model's JAX draw at 8 bits, as JAX's tree and the port's."""
    out = {}
    jmcfg = JMadamConfig(update_format=JFormat(bits=8, gamma=8))
    for arch in MODALITY:
        jcfg = j_smoke_config(arch)
        jparams = jax.jit(lambda k: j_init_train_state(k, jcfg, jmcfg)
                          .params)(jax.random.PRNGKey(0))
        out[arch] = (jparams, params_from_flat(flat_params(jparams), FMT8,
                                               device="cpu"))
    return out


_ENGINE_KW = dict(num_slots=2, max_len=32, page_size=4, num_pages=16)


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("arch", MODALITY)
def test_engine_streams_match_jax(arch, prefix_cache, packed_draws):
    """Greedy streams of 4 requests sharing a two-page prefix (2 slots,
    page 4) equal JAX's engine's; with the cache the hits, reused tokens
    and the registry's page ids equal JAX's too (chain keys over the
    ``(len, K)`` rows), and no page stays in use."""
    from repro.serving import Engine as JEngine
    from repro.serving import Request as JRequest
    from repro_torch.serving import Engine
    jcfg, tcfg = j_smoke_config(arch), get_smoke_config(arch)
    jparams, tp = packed_draws[arch]
    reqs = _shared_requests(tcfg)
    with jd.configured(backend="reference"):
        jeng = JEngine(jcfg, JQuantConfig.lns_madam(),
                       JMadamConfig(update_format=JFormat(bits=8, gamma=8)),
                       jparams, prefix_cache=prefix_cache, **_ENGINE_KW)
        jeng.run([JRequest(rid=r.rid, prompt=r.prompt,
                           max_new_tokens=r.max_new_tokens) for r in reqs])
    eng = Engine(tcfg, QuantConfig.lns_madam(), tp, device="cpu",
                 prefix_cache=prefix_cache, **_ENGINE_KW)
    eng.run(reqs)
    assert len(_streams(eng)) == 4
    assert _streams(eng) == _streams(jeng)
    if tcfg.num_codebooks:
        assert all(len(t) == tcfg.num_codebooks
                   for s in _streams(eng).values() for t in s)
    assert eng.prefix_hits == jeng.prefix_hits
    assert eng.prefix_reused_tokens == jeng.prefix_reused_tokens
    assert eng.allocator._registry == jeng.allocator._registry
    assert (eng.prefix_hits > 0) == prefix_cache
    assert eng.allocator.in_use == 0


def test_chain_keys_over_codebook_rows_equal_jax():
    from repro.serving.scheduler import BlockAllocator as JAllocator
    from repro_torch.serving.scheduler import BlockAllocator
    rows = np.random.default_rng(1).integers(0, 64, (13, 4)).tolist()
    assert BlockAllocator.chain_keys(rows, 4) == JAllocator.chain_keys(rows, 4)
    assert len(BlockAllocator.chain_keys(rows, 4)) == 3


@pytest.fixture(scope="module")
def jax_engines(packed_draws):
    """JAX's engine of each model (not run: ``validate`` only)."""
    from repro.serving import Engine as JEngine
    jmcfg = JMadamConfig(update_format=JFormat(bits=8, gamma=8))
    return {arch: JEngine(j_smoke_config(arch), JQuantConfig.lns_madam(),
                          jmcfg, packed_draws[arch][0], **_ENGINE_KW)
            for arch in MODALITY}


BAD_PROMPTS = {
    "flat ids to a codebook model": ("musicgen-medium", [1, 2, 3]),
    "3 of 4 codebooks": ("musicgen-medium", [[1, 2, 3], [4, 5, 6]]),
    "ragged rows": ("musicgen-medium", [[1, 2, 3, 4], [5, 6]]),
    "an id past the vocab": ("musicgen-medium", [[1, 2, 3, 64]]),
    "codebook rows to a flat model": ("phi-3-vision-4.2b", [[1, 2], [3, 4]]),
    "no rows": ("musicgen-medium", np.zeros((0, 4), np.int32)),
}


@pytest.mark.parametrize("case", list(BAD_PROMPTS))
def test_validate_errors_equal_jax(case, jax_engines, packed_draws):
    from repro_torch.serving import Engine
    arch, prompt = BAD_PROMPTS[case]
    eng = Engine(get_smoke_config(arch), QuantConfig.lns_madam(),
                 packed_draws[arch][1], device="cpu", **_ENGINE_KW)
    with pytest.raises(ValueError) as want:
        jax_engines[arch].validate(prompt, 4)
    with pytest.raises(ValueError) as got:
        eng.validate(prompt, 4)
    assert str(got.value) == str(want.value)
    # a well-formed prompt passes both
    ok = [[1, 2, 3, 4]] * 3 if arch == "musicgen-medium" else [1, 2, 3]
    jax_engines[arch].validate(ok, 4)
    eng.validate(ok, 4)


def test_spec_refused_for_codebooks_allowed_for_phi3v(packed_draws):
    """musicgen's engine and ``launch.serve --speculate-k`` raise JAX's
    codebook reason; phi-3-vision (dense) speculates."""
    from repro.serving import Engine as JEngine
    from repro_torch.launch import serve
    from repro_torch.serving import Engine
    tcfg = get_smoke_config("musicgen-medium")
    with pytest.raises(ValueError) as want:
        JEngine(j_smoke_config("musicgen-medium"), JQuantConfig.lns_madam(),
                JMadamConfig(), packed_draws["musicgen-medium"][0],
                speculate_k=2)
    assert "multi-codebook" in str(want.value)
    with pytest.raises(ValueError) as got:
        Engine(tcfg, QuantConfig.lns_madam(),
               packed_draws["musicgen-medium"][1], device="cpu",
               speculate_k=2)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="multi-codebook"):
        serve.main(["--arch", "musicgen-medium", "--smoke", "--device", "cpu",
                    "--page-size", "4", "--speculate-k", "2",
                    "--requests", "1"])
    pcfg = get_smoke_config("phi-3-vision-4.2b")
    eng = Engine(pcfg, QuantConfig.lns_madam(),
                 packed_draws["phi-3-vision-4.2b"][1], device="cpu",
                 speculate_k=2, draft_bitwidth=7, **_ENGINE_KW)
    eng.run(_shared_requests(pcfg, n=2))
    assert len(eng.finished) == 2 and eng.spec_cycles > 0


@pytest.mark.parametrize("arch", MODALITY)
def test_serve_cli_runs_on_cpu(arch):
    """``launch.serve --arch`` for both models (musicgen's trace has
    (len, 4) prompts), paged at page 4."""
    from repro_torch.launch import serve
    agg = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--page-size", "4", "--requests", "3", "--slots", "2",
                      "--prompt-len", "6", "--gen-len", "4"])
    assert agg["completed"] == 3


@pytest.mark.parametrize("arch", MODALITY)
def test_train_cli_runs_on_cpu(arch):
    from repro_torch.launch import train
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "8"])
    assert out["steps"] == 2 and all(np.isfinite(out["losses"]))


def test_codebook_prompt_through_the_live_gateway(packed_draws):
    """A musicgen gateway on loopback: a (len, 4) prompt, unary and over
    SSE, gives the offline engine's greedy stream of id rows; a flat
    prompt gets the engine's refusal as a 400."""
    from repro_torch.server import sse
    from repro_torch.server.app import Gateway
    from repro_torch.server.driver import EngineDriver
    from repro_torch.serving import Engine, Request
    cfg = get_smoke_config("musicgen-medium")
    tp = packed_draws["musicgen-medium"][1]
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (7, 4)).tolist()
    offline = Engine(cfg, QuantConfig.lns_madam(), tp, device="cpu",
                     **_ENGINE_KW)
    offline.run([Request(rid=0, prompt=prompt, max_new_tokens=5)])
    want = offline.finished[0].generated
    engine = Engine(cfg, QuantConfig.lns_madam(), tp, device="cpu",
                    **_ENGINE_KW)
    driver = EngineDriver(engine, max_inflight=4).start()
    loop = asyncio.new_event_loop()
    started = {}

    def run_loop():
        asyncio.set_event_loop(loop)
        gw = loop.run_until_complete(Gateway(driver, port=0,
                                             model=cfg.name).start())
        started["gw"], started["addr"] = gw, gw.address
        loop.run_forever()

    t = threading.Thread(target=run_loop, daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while "addr" not in started and time.monotonic() < deadline:
        time.sleep(0.01)
    host, port = started["addr"]

    async def post(body):
        reader, writer = await asyncio.open_connection(host, port)
        payload = json.dumps(body).encode()
        writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                      f"Content-Length: {len(payload)}\r\n\r\n").encode()
                     + payload)
        await writer.drain()
        raw = await reader.read()
        writer.close()
        head, _, data = raw.partition(b"\r\n\r\n")
        return int(head.split()[1]), data

    try:
        status, data = asyncio.run(post({"prompt": prompt, "max_tokens": 5}))
        assert status == 200
        assert json.loads(data)["choices"][0]["token_ids"] == want
        status, data = asyncio.run(post({"prompt": prompt, "max_tokens": 5,
                                         "stream": True}))
        assert status == 200
        tokens = []
        for ev in sse.SSEParser().feed(data):
            if ev != sse.DONE:
                tokens += json.loads(ev)["choices"][0]["delta"]["token_ids"]
        assert tokens == want
        status, data = asyncio.run(post({"prompt": [1, 2, 3],
                                         "max_tokens": 5}))
        assert status == 400 and b"(len, 4)" in data
    finally:
        asyncio.run_coroutine_threadsafe(started["gw"].stop(),
                                         loop).result(5)
        loop.call_soon_threadsafe(loop.stop)
        t.join(5)
        driver.shutdown()
    assert engine.allocator.in_use == 0
