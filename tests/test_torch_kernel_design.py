"""The Hopper designs of K2 and K5, checked on their plain versions.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against their plain versions there). What the CPU can check is that the
orders of summation and the partitions the kernels use compute the same
function, within the tolerances ``chip_smoke.py`` states (imported from
it, so the two cannot drift apart):

* K2's skinny path sums 16-deep K steps inside a block and the split-K
  partials in split order; the wgmma path sums 16-deep steps in K order.
  Both equal the plain order within ``K2_RTOL`` of the output's max at
  every main-path shape, and one flipped weight word (the control) does
  not, so the chip check can see a wrong decode.
* K5's four warps take pages w, w+4, ... and keep their own online-softmax
  state over chunks of positions; the states merge by the log-sum-exp rule
  in warp order. That equals ``ref.paged_attend`` within ``K5_ATOL``,
  also where a warp sees no position at all.
* K2's host-side plan: the path, the grid and the split for every
  main-path shape.
* K2's decode pass (the wgmma path's first kernel): the padded K-major
  operands hold the decoded words and zeros past M, N and K (not the +1.0
  a zero word decodes to), and multiply to the plain K2.
* The fused output cast: the plain K2 with ``out_dtype=bf16`` equals its
  f32 result cast to bf16, bit for bit.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.lns import LNSFormat, lns_decode_packed  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import K2_RTOL, K5_ATOL  # noqa: E402

FMT = LNSFormat(8, 8)
GEMMS = [(576, 576), (576, 192), (576, 1536), (1536, 576)]
MAIN_SHAPES = [(m, k, n) for m in (4, 16, 32, 2048) for k, n in GEMMS]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _k2_operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    pa, sa = ref.encode_pack(x.to(torch.bfloat16), FMT)
    pb = torch.from_numpy(rng.integers(0, 256, (K, N), dtype=np.uint8))
    sb = torch.from_numpy(np.exp2(rng.integers(-6, -2, (1, N))).astype(
        np.float32))
    return pa, pb, sa, sb


def _k2_in_kernel_order(pa, pb, sa, sb, plan):
    """The plain K2 summed as the planned kernel sums: f32 partials of
    16-deep K steps, accumulated step by step within a warp; on the skinny
    path the warps of a block in warp order, then the split-K
    partials in split order; then acc*sa, then *sb."""
    a = lns_decode_packed(pa, FMT, torch.bfloat16).float()
    b = lns_decode_packed(pb, FMT, torch.bfloat16).float()
    K = a.shape[1]

    def steps(k0, k1):
        acc = torch.zeros(a.shape[0], b.shape[1])
        for k in range(k0, min(k1, K), 16):
            acc = acc + a[:, k:k + 16] @ b[k:k + 16]
        return acc

    if plan["path"] != "skinny":
        return steps(0, K) * sa * sb
    per_warp, warps = plan["steps"] * 16, plan["warps"]
    total = None
    for k0 in range(0, K, warps * per_warp):
        block = steps(k0, k0 + per_warp)
        for w in range(1, warps):
            block = block + steps(k0 + w * per_warp, k0 + (w + 1) * per_warp)
        total = block if total is None else total + block
    return total * sa * sb


@pytest.mark.parametrize("mkn", MAIN_SHAPES)
def test_k2_kernel_orders_match_plain(mkn):
    M, K, N = mkn
    pa, pb, sa, sb = _k2_operands(M, K, N, seed=M + K + N)
    plan = ops.qmatmul_plan(M, N, K)
    want = ref.qmatmul(pa, pb, FMT, sa, sb)
    got = _k2_in_kernel_order(pa, pb, sa, sb, plan)
    lim = K2_RTOL * float(want.abs().max())
    assert float((got - want).abs().max()) <= lim


@pytest.mark.parametrize("mkn", [(4, 576, 576), (32, 1536, 576),
                                 (2048, 576, 192)])
def test_k2_one_flipped_word_exceeds_tolerance(mkn):
    """The control: flip the sign of the weight word with the largest
    contribution; the plain output moves by more than ``K2_RTOL``."""
    M, K, N = mkn
    pa, pb, sa, sb = _k2_operands(M, K, N, seed=7)
    want = ref.qmatmul(pa, pb, FMT, sa, sb)
    a = lns_decode_packed(pa, FMT, torch.float32).abs().max(dim=0).values
    b = lns_decode_packed(pb, FMT, torch.float32).abs()
    k, n = divmod(int((a[:, None] * b * sb).argmax()), N)
    flipped = pb.clone()
    flipped[k, n] ^= 1 << (FMT.bits - 1)
    got = ref.qmatmul(pa, flipped, FMT, sa, sb)
    assert float((got - want).abs().max()) > K2_RTOL * float(
        want.abs().max())


@pytest.mark.parametrize("mkn", MAIN_SHAPES + [(128, 576, 1536),
                                 (256, 576, 1536), (512, 1536, 576)])
def test_k2_plan(mkn, monkeypatch):
    M, K, N = mkn
    plan = ops.qmatmul_plan(M, N, K)
    if M >= ops.QMATMUL_WGMMA_MIN_M:
        assert plan["path"] == "wgmma" and plan["splits"] == 1
        assert plan["blocks"] == -(-M // 128) * -(-N // 128)
    else:
        assert plan["path"] == "skinny"
        assert plan["mt8"] == (1 if M <= 8 else 2)
        assert 1 <= plan["steps"] <= 6
        per_block = plan["warps"] * plan["steps"] * 16
        assert plan["splits"] * per_block >= K > (plan["splits"] - 1) * \
            per_block
        # one 8-warp block takes all of K where each warp's share fits 6
        # steps (K=576: no split-K round trip); K=1536 splits over >= 132
        # warps of 3 steps
        one = K <= 8 * 6 * 16
        assert (plan["splits"] == 1) == one
        assert plan["warps"] == (8 if one else 4)
        if not one:
            assert plan["steps"] == 3 and plan["blocks"] * 4 >= 132
    assert ops.qmatmul_plan(M, N, K, torch.float32)["path"] == "f32"
    # f32 compute takes the f32 path wherever the bf16 threshold lies
    monkeypatch.setattr(ops, "QMATMUL_WGMMA_MIN_M", 0)
    assert ops.qmatmul_plan(M, N, K, torch.float32)["path"] == "f32"


def test_k2_plan_forced_paths_and_threshold(monkeypatch):
    """The plan reads its threshold and step constants when called, so
    chip_smoke.py can move them to time the other path or another split."""
    t = ops.QMATMUL_WGMMA_MIN_M
    assert ops.qmatmul_plan(t - 1, 576, 576)["path"] == "skinny"
    assert ops.qmatmul_plan(t, 576, 576)["path"] == "wgmma"
    monkeypatch.setattr(ops, "QMATMUL_WGMMA_MIN_M", 0)
    assert ops.qmatmul_plan(4, 576, 576)["path"] == "wgmma"
    monkeypatch.setattr(ops, "QMATMUL_WGMMA_MIN_M", 1 << 62)
    assert ops.qmatmul_plan(256, 576, 576)["path"] == "skinny"
    monkeypatch.setattr(ops, "_SK_ONE_STEPS", 0)
    monkeypatch.setattr(ops, "_SK_SPLIT_STEPS", 2)
    plan = ops.qmatmul_plan(4, 576, 576)
    assert (plan["warps"], plan["steps"], plan["splits"]) == (4, 2, 5)


@pytest.mark.parametrize("mkn", [(2048, 576, 192), (2047, 584, 1543),
                                 (5, 77, 130), (300, 64, 128)])
def test_k2_decode_pass_plain(mkn):
    M, K, N = mkn
    pa, pb, sa, sb = _k2_operands(M, K, N, seed=13)
    ad, bt = ref.qmatmul_decode(pa, pb, FMT)
    mp, np_, kp = (-(-M // 128) * 128, -(-N // 128) * 128, -(-K // 64) * 64)
    assert ad.shape == (mp, kp) and bt.shape == (np_, kp)
    assert ad.dtype == bt.dtype == torch.bfloat16
    assert torch.equal(ad[:M, :K], lns_decode_packed(pa, FMT, torch.bfloat16))
    assert torch.equal(bt[:N, :K],
                       lns_decode_packed(pb, FMT, torch.bfloat16).T)
    assert not ad[M:].any() and not ad[:, K:].any()
    assert not bt[N:].any() and not bt[:, K:].any()
    got = (ad.float() @ bt.float().T)[:M, :N] * sa * sb
    want = ref.qmatmul(pa, pb, FMT, sa, sb)
    assert float((got - want).abs().max()) <= K2_RTOL * float(
        want.abs().max())


@pytest.mark.parametrize("mkn", [(4, 64, 48), (32, 96, 40), (3, 256, 17),
                                 (5, 577, 193), (4, 576, 576),
                                 (4, 1536, 576), (16, 576, 192)])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_k2_bf16_out_is_one_rounding(mkn, cdt):
    M, K, N = mkn
    pa, pb, sa, sb = _k2_operands(M, K, N, seed=11)
    f32 = ref.qmatmul(pa, pb, FMT, sa, sb, compute_dtype=cdt)
    bf16 = ref.qmatmul(pa, pb, FMT, sa, sb, compute_dtype=cdt,
                       out_dtype=torch.bfloat16)
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))


# ---------------------------------------------------------------- K5

WARPS = 4


def _chunk(page):
    """Positions a K5 warp takes at once: the page when it is a power of
    two below 32, else 32."""
    return page if page < 32 and 32 % page == 0 else 32


def _k5_warp_split(q, kp, vp, ks, vs, bt, ln, *, fmt, softcap, sm_scale):
    """K5 as the kernel partitions it, in plain torch: warp w walks pages
    w, w+4, ... in chunks of positions with its own (m, l, acc) for every
    query row; the four states merge in warp order."""
    B, S, H, hd = q.shape
    page, KV = kp.shape[1], kp.shape[2]
    rep = H // KV
    out = torch.zeros((B, S, H, hd), dtype=torch.float32)
    for b in range(B):
        n = int(ln[b])
        n_pages = min(-(-n // page), bt.shape[1])
        for g in range(KV):
            qg = q[b, :, g * rep:(g + 1) * rep].float().reshape(S * rep, hd)
            qpos = n - S + torch.arange(S * rep) // rep
            states = []
            for w in range(WARPS):
                m = torch.full((S * rep,), -1e30)
                l = torch.zeros(S * rep)
                acc = torch.zeros(S * rep, hd)
                for pi in range(w, n_pages, WARPS):
                    pg = int(bt[b, pi])
                    kf, vf = kp[pg, :, g].float(), vp[pg, :, g].float()
                    if fmt is not None:
                        kf = lns_decode_packed(kp[pg, :, g], fmt,
                                               torch.float32) * \
                            ks[pg, :, g].float()
                        vf = lns_decode_packed(vp[pg, :, g], fmt,
                                               torch.float32) * \
                            vs[pg, :, g].float()
                    ch = _chunk(page)
                    for p0 in range(0, page, ch):
                        pos = pi * page + p0 + torch.arange(
                            min(ch, page - p0))
                        sc = qg @ kf[p0:p0 + ch].T * sm_scale
                        if softcap is not None:
                            sc = softcap * torch.tanh(sc / softcap)
                        vis = pos[None, :] <= qpos[:, None]
                        live = vis.any(dim=1)
                        sc = torch.where(vis, sc, torch.full((), -1e30))
                        m_new = torch.where(live, torch.maximum(
                            m, sc.max(dim=1).values), m)
                        corr = torch.exp(m - m_new)
                        pe = torch.where(vis, torch.exp(sc - m_new[:, None]),
                                         torch.zeros(()))
                        l = corr * l + pe.sum(dim=1)
                        acc = corr[:, None] * acc + pe @ vf[p0:p0 + ch]
                        m = m_new
                states.append((m, l, acc))
            mx = torch.stack([s[0] for s in states]).max(dim=0).values
            den = torch.zeros_like(mx)
            num = torch.zeros(S * rep, hd)
            for m, l, acc in states:        # fixed warp order
                f = torch.exp(m - mx)
                den = den + l * f
                num = num + acc * f[:, None]
            res = num / torch.clamp_min(den, 1e-30)[:, None]
            out[b, :, g * rep:(g + 1) * rep] = res.reshape(S, rep, hd)
    return out


def _k5_inputs(B, S, lengths, packed, page, seed, heads=(6, 2, 32), mp=5):
    H, KV, hd = heads
    rng = np.random.default_rng(seed)
    P = B * mp + 1
    q = torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(
        np.float32)).to(torch.bfloat16)
    bt = torch.from_numpy(rng.permutation(P - 1)[:B * mp].reshape(
        B, mp).astype(np.int32))
    ln = torch.tensor(lengths, dtype=torch.int32)
    if packed:
        kp = torch.from_numpy(rng.integers(0, 256, (P, page, KV, hd),
                                           dtype=np.uint8))
        vp = torch.from_numpy(rng.integers(0, 256, (P, page, KV, hd),
                                           dtype=np.uint8))
        ks, vs = (torch.from_numpy(np.exp2(rng.integers(
            -2, 3, (P, page, KV, 1))).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    else:
        kp, vp = (torch.from_numpy(rng.standard_normal(
            (P, page, KV, hd)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
        ks = vs = None
    return q, kp, vp, ks, vs, bt, ln


K5_CASES = {
    "decode": (4, 1, [33, 48, 61, 66], 16),
    "verify": (4, 4, [36, 45, 52, 63], 16),
    "prefill": (1, 32, [32], 16),
    "decode_page4": (3, 1, [9, 14, 20], 4),
    # one visible page for four warps: warps 1-3 merge as no-ops
    "empty_warps": (4, 1, [9, 1, 16, 5], 16),
    # a page longer than a 32-position chunk
    "page64": (2, 2, [40, 100], 64),
}


@pytest.mark.parametrize("case", list(K5_CASES))
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_k5_warp_split_matches_plain(case, packed, softcap):
    B, S, lengths, page = K5_CASES[case]
    mp = 2 if page == 64 else 5
    args = _k5_inputs(B, S, lengths, packed, page, seed=len(case), mp=mp)
    kw = dict(fmt=FMT if packed else None, softcap=softcap,
              sm_scale=1 / np.sqrt(32))
    want = ref.paged_attend(*args, **kw)
    got = _k5_warp_split(*args, **kw)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= K5_ATOL
