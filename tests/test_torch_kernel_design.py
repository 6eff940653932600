"""The Hopper designs of K1, K2, K5, K6, K7 and K8, checked on their plain
versions.

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
  also where a warp sees no position at all; and at head_dim 96 with the
  logits summed in the kernel's order of 16-byte pieces (6, 12 or 24 a
  row for u8, bf16 and f32 pools).
* K2's host-side plan: the path, the grid and the split for every
  main-path shape.
* K2's decode pass (the wgmma path's first kernel): the padded K-major
  operands hold the decoded words and zeros past M, N and K (not the +1.0
  a zero word decodes to), and multiply to the plain K2.
* The fused output cast: the plain K2 with ``out_dtype=bf16`` equals its
  f32 result cast to bf16, bit for bit.
* K1's one launch: block maxima of |x|'s bit patterns over the kernel's
  chunks, met in any order, then one f32 log2/ceil/exp2 finalize, give
  ``ref.row_scale`` bit for bit and ``ref.encode_pack``'s words, at an
  absmax of 2^k and one ulp either side for every f32 exponent, with NaN
  and inf, per tensor and per row. H12: the port's scale is an exact power
  of two at every exponent.
* K8's term table (the whole signed term of m = ca + cb, built by the
  datapath's own integer arithmetic) equals the per-product magnitude at
  every format and LUT kind it takes; its split-K (each split's collector
  carried as ``acc -> clamp(acc + c, lo, hi)``, applied in K order)
  replays the 24-bit collector exactly, saturating both ways and on a
  partial last slice; its plan.
* K7's re-grid of four packed bytes in one 32-bit word (no lane carries
  into its neighbour) equals ``ref.requant_pack`` for every byte value in
  every lane, up- and down-grids; its 16-byte units cover each byte of a
  leaf once, misaligned or ragged.
* K6's row split (chunks of a multiple of 4, a scalar head, float4
  groups, a tail, blocks merged in rank order) gives the first maximum
  under any split; its plan.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import conversion  # noqa: E402
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


def _k5_piece_dots(qg, kf, page, elem):
    """The logits ``qg (R, hd) . kf (n, hd)^T`` in K5's order: the SUB =
    32 / P lanes of a position take the 16-byte pieces of its K row (E =
    16 / elem values each) as sh, sh + SUB, sh + 2 SUB, ..., alternating
    between two fused multiply-add chains (pieces c and c + SUB of each
    2 SUB stride), add the two, then combine the SUB lanes by xor
    shuffles (all lanes end equal). Each fma is emulated in f64, rounded
    to f32."""
    hd = qg.shape[1]
    P = _chunk(page)
    SUB = 32 // P
    E = 16 // elem
    n_pc = hd * elem // 16
    q64, k64 = qg.double()[:, None, :], kf.double()[None, :, :]
    lanes = []
    for sh in range(SUB):
        part = [torch.zeros(qg.shape[0], kf.shape[0]) for _ in range(2)]
        for c in range(sh, n_pc, 2 * SUB):
            for u in range(2):
                cc = c + u * SUB
                if cc >= n_pc:
                    break
                for d in range(cc * E, cc * E + E):
                    part[u] = (q64[..., d] * k64[..., d]
                               + part[u].double()).float()
        lanes.append(part[0] + part[1])
    o = 1
    while o < SUB:
        lanes = [lanes[i] + lanes[i ^ o] for i in range(SUB)]
        o <<= 1
    return lanes[0]


def _k5_warp_split(q, kp, vp, ks, vs, bt, ln, *, fmt, softcap, sm_scale,
                   pieces=False):
    """K5 as the kernel partitions it, in plain torch: warp w walks pages
    w, w+4, ... in chunks of positions with its own (m, l, acc) for every
    query row; the four states merge in warp order. ``pieces`` takes the
    logits in the kernel's 16-byte piece order (``_k5_piece_dots``)."""
    elem = kp.element_size()
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
                        sc = (_k5_piece_dots(qg, kf[p0:p0 + ch], page,
                                             elem) if pieces
                              else qg @ kf[p0:p0 + ch].T) * sm_scale
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


def _k5_inputs(B, S, lengths, packed, page, seed, heads=(6, 2, 32), mp=5,
               pool=torch.bfloat16):
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
            (P, page, KV, hd)).astype(np.float32)).to(pool)
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


# phi-3-vision's head_dim 96: a row is 6 (u8), 12 (bf16) or 24 (f32)
# 16-byte pieces; at page 16 the two lanes of a position take 3, 6 or 12
# each, at page 4 (SUB = 8) some lanes take one piece or none
K5_HD96_CASES = {
    "decode": (2, 1, [33, 61], 16),
    "verify": (2, 4, [36, 52], 16),
    "empty_warps": (2, 1, [9, 1], 16),
    "decode_page4": (2, 1, [9, 14], 4),
}


@pytest.mark.parametrize("case", list(K5_HD96_CASES))
@pytest.mark.parametrize("pool", ["bf16", "packed", "f32"])
def test_k5_head_dim_96_piece_order_matches_plain(case, pool):
    """K5's logits in the kernel's piece order and its warp split at
    head_dim 96 (2 query heads a KV head) equal ``ref.paged_attend``
    within ``K5_ATOL``."""
    B, S, lengths, page = K5_HD96_CASES[case]
    args = _k5_inputs(B, S, lengths, pool == "packed", page, seed=len(case),
                      heads=(4, 2, 96), mp=5,
                      pool=torch.float32 if pool == "f32" else torch.bfloat16)
    assert args[1].element_size() == {"bf16": 2, "packed": 1, "f32": 4}[pool]
    kw = dict(fmt=FMT if pool == "packed" else None, softcap=None,
              sm_scale=1 / np.sqrt(96))
    want = ref.paged_attend(*args, **kw)
    got = _k5_warp_split(*args, **kw, pieces=True)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= K5_ATOL


# zamba2's head_dim 112: a row is 7 (u8), 14 (bf16) or 28 (f32) 16-byte
# pieces, odd for u8, so at page 16 one lane of a position takes a piece
# more than the other
K5_HD112_CASES = {
    "decode": (2, 1, [33, 61], 16),
    "prefill": (1, 8, [8], 16),
    "empty_warps": (2, 1, [9, 1], 16),
    "decode_page4": (2, 1, [9, 14], 4),
}


@pytest.mark.parametrize("case", list(K5_HD112_CASES))
@pytest.mark.parametrize("pool", ["bf16", "packed", "f32"])
def test_k5_head_dim_112_piece_order_matches_plain(case, pool):
    """K5's logits in the kernel's piece order and its warp split at
    head_dim 112 (one query head a KV head, as zamba2's 32 / 32) equal
    ``ref.paged_attend`` within ``K5_ATOL``."""
    B, S, lengths, page = K5_HD112_CASES[case]
    args = _k5_inputs(B, S, lengths, pool == "packed", page, seed=len(case),
                      heads=(2, 2, 112), mp=5,
                      pool=torch.float32 if pool == "f32" else torch.bfloat16)
    kw = dict(fmt=FMT if pool == "packed" else None, softcap=None,
              sm_scale=1 / np.sqrt(112))
    want = ref.paged_attend(*args, **kw)
    got = _k5_warp_split(*args, **kw, pieces=True)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= K5_ATOL


def _k5_pv_dims(hd, guard):
    """The dims each (lane, group d) of K5's P.V reads and writes, by
    ``guard(d, lane, hd)``: DPL = ceil(hd / 32) groups of 32 lanes."""
    dpl = -(-hd // 32)
    return [d * 32 + lane for d in range(dpl) for lane in range(32)
            if guard(d, lane, hd)]


@pytest.mark.parametrize("hd", [16, 32, 64, 96, 112, 128, 256])
def test_k5_pv_lane_map_covers_each_dim_once(hd):
    """P.V's lane-to-dim map (``paged_attend.cu``: lane l of group d holds
    dim d * 32 + l where ``HD % 32 == 0 || d * 32 + l < HD``) covers dims
    0..hd-1 exactly once at every built head_dim. The guard it replaced
    (``HD % 32 == 0 || lane < HD``) did so only below 32: at 112 its
    fourth group reached dims 112-127, past the row (the K read went into
    the row's pad and the next row, the merge wrote past ``aa``'s row)."""
    fixed = _k5_pv_dims(hd, lambda d, l, h: h % 32 == 0 or d * 32 + l < h)
    assert sorted(fixed) == list(range(hd))
    old = _k5_pv_dims(hd, lambda d, l, h: h % 32 == 0 or l < h)
    assert (sorted(old) == list(range(hd))) == (hd % 32 == 0 or hd < 32)
    if hd == 112:
        assert max(old) == 127 and len(old) == 128


# ---------------------------------------------------------------- K1

K1_SMS = 132
TINY = torch.finfo(torch.float32).tiny


def _k1_chunks(n, itemsize):
    """K1's per-tensor partition (``launch`` in lns_quantize.cu, with the
    wrapper's constants): one block up to ``_K1_ONE_BLOCK`` elements, else
    a block a ``_K1_MIN_CHUNK`` up to one an SM, chunks of whole 16-byte
    vectors."""
    vec = 16 // itemsize
    nb = 1 if n <= ops._K1_ONE_BLOCK else min(-(-n // ops._K1_MIN_CHUNK),
                                              K1_SMS)
    chunk = -(-(-(-n // nb)) // vec) * vec
    return [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]


def _abs_bits(x):
    """|x|'s f32 bit patterns as int64: ordered as the values, NaN above
    +inf (the kernel's unsigned max)."""
    return (x.float().contiguous().view(torch.int32).to(torch.int64)
            & 0x7FFFFFFF)


def _finalize(bits):
    """The kernel's scale from the max's bits: NaN-keeping clamp to tiny,
    then log2, ceil, exp2 in f32."""
    a = bits.to(torch.int32).view(torch.float32)
    a = torch.where(a < TINY, torch.full((), TINY), a)
    return torch.exp2(torch.ceil(torch.log2(a)))


def _k1_partitioned(x, fmt, scale_axis, seed):
    """K1 as the kernel partitions it, in plain torch: per tensor, block
    maxima of the chunks met in a scrambled block order; per row, one
    warp's max; one f32 finalize; then the encode in the kernel's order
    (|x| times the exact reciprocal of a normal pow2 scale, NaN-keeping
    clamps, NaN codes to 0)."""
    R, C = x.shape
    bits = _abs_bits(x)
    if scale_axis == 0:
        s = _finalize(bits.amax(dim=1, keepdim=True))
    else:
        flat = bits.reshape(-1)
        maxima = [flat[lo:hi].max() for lo, hi in
                  _k1_chunks(flat.numel(), x.element_size())]
        order = np.random.default_rng(seed).permutation(len(maxima))
        m = torch.zeros((), dtype=torch.int64)
        for i in order:
            m = torch.maximum(m, maxima[i])
        s = _finalize(m).reshape(1, 1).expand(R, 1)
    sb = s.view(torch.int32)
    pow2 = ((sb & 0x7FFFFF) == 0) & (sb >= 0x00800000) & (sb < 0x7F800000)
    xf = x.float()
    mag = torch.where(pow2, xf.abs() * (1.0 / s), xf.abs() / s)
    mag = torch.where(mag < TINY, torch.full((), TINY), mag)
    e = torch.floor(-torch.log2(mag) * fmt.gamma + 0.5)
    e = torch.nan_to_num(e, nan=0.0).clamp(0, fmt.max_code)
    word = ((xf < 0).to(torch.int32) << (fmt.bits - 1)) | e.to(torch.int32)
    return word.to(torch.uint8), s.contiguous()


def _edge_amax(k, ulp, dtype):
    """2^k moved by ``ulp`` units in the last place of ``dtype``."""
    v = torch.tensor(2.0 ** k, dtype=dtype)
    if ulp:
        v = torch.nextafter(v, torch.tensor(np.inf if ulp > 0 else 0.0,
                                            dtype=dtype))
    return float(v)


def _same(a, b):
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        torch.where(a.isnan(), 0.0, a), torch.where(b.isnan(), 0.0, b))


K1_EXPONENTS = list(range(-126, 128))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale_axis", [None, 0])
@pytest.mark.parametrize("case", ["pow2_edges", "nan", "inf", "serving"])
def test_k1_partition_matches_plain(dtype, scale_axis, case):
    """Block maxima in a scrambled order and one f32 finalize give
    ``ref.row_scale``'s scale bit for bit and ``ref.encode_pack``'s words:
    at absmax 2^k and one ulp either side for every f32 exponent, with a
    NaN or an inf in x, and at the serving and a multi-block shape."""
    rng = np.random.default_rng(16)
    xs = []
    if case == "pow2_edges":
        # 8 rows a tensor, one (k, ulp) a row: per row each row's absmax
        # sits on the edge, per tensor the largest row's
        edges = [(k, u) for k in K1_EXPONENTS for u in (-1, 0, 1)]
        for i in range(0, len(edges), 8):
            rows = edges[i:i + 8]
            x = rng.uniform(-0.45, 0.45, (len(rows), 40)).astype(np.float32)
            x = torch.from_numpy(x)
            for r, (k, u) in enumerate(rows):
                x[r] = x[r] * 2.0 ** k
                x[r, (7 * r) % 40] = _edge_amax(k, u, dtype) * (-1) ** r
            xs.append(x.to(dtype))
    elif case in ("nan", "inf"):
        for shape in [(4, 576), (32, 1536)]:
            x = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32))
            x[1, 5] = np.nan if case == "nan" else np.inf
            x[2, 9] = -np.inf if case == "inf" else 1.0
            xs.append(x.to(dtype))
    else:
        for shape in [(4, 576), (4, 1536), (32, 1536), (96, 1536),
                      (5, 77)]:
            xs.append(torch.from_numpy(
                (rng.standard_normal(shape) * 3.0).astype(np.float32)
            ).to(dtype))
    for i, x in enumerate(xs):
        kw, ks = _k1_partitioned(x, FMT, scale_axis, seed=i)
        pw, ps = ref.encode_pack(x, FMT, scale_axis)
        assert _same(ks, ps)
        assert torch.equal(ks.isnan(), ref.row_scale(x, scale_axis).isnan())
        assert torch.equal(kw, pw)


def test_k1_chunks_cover_the_tensor():
    """The partition: whole vectors, at most one block an SM, one block
    for the decode shapes, every element in exactly one chunk."""
    for n, item in [(4 * 576, 2), (4 * 1536, 2), (32 * 1536, 2),
                    (2048 * 1536, 2), (2048 * 1536, 4), (5 * 77, 4)]:
        chunks = _k1_chunks(n, item)
        assert len(chunks) <= K1_SMS
        assert chunks[0][0] == 0 and chunks[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        assert all((hi - lo) % (16 // item) == 0 for lo, hi in chunks[:-1])
        if n <= ops._K1_ONE_BLOCK:
            assert len(chunks) == 1
        else:
            assert len(chunks) > 1


def test_h12_row_scale_is_an_exact_power_of_two():
    """H12: the port's scale is 2^ceil(log2(absmax)) with a zero mantissa
    at every exponent (the JAX reference's XLA-CPU exp2 is not exact
    there); an absmax of exactly 2^k gives 2^k."""
    for k in range(-126, 128):
        for u in (-1, 0, 1):
            a = _edge_amax(k, u, torch.float32)
            x = torch.tensor([[a, -a / 3.0]], dtype=torch.float32)
            s = ref.row_scale(x)
            bits = int(s.view(torch.int32))
            assert bits & 0x7FFFFF == 0 and 0 < bits < 0x7F800000
            e = int(torch.ceil(torch.log2(torch.tensor(a, dtype=torch.float32)
                                          .clamp_min(TINY))))
            assert float(s) == math.ldexp(1.0, e)
            if u == 0:
                assert float(s) == 2.0 ** k


# ---------------------------------------------------------------- K8

SAT = ref.SAT24


def _k8_lut(fmt, frac_bits, lut_entries):
    if lut_entries is None:
        return conversion.remainder_lut_neg_int(fmt.gamma, frac_bits)
    return conversion.remainder_lut_neg_shifted_int(fmt.gamma, frac_bits,
                                                    lut_entries)


def _k8_term_table(fmt, frac_bits, lut_entries):
    """The kernel's prologue: T[m + 256 s] for s = sa + sb, the datapath's
    magnitude of m = ca + cb by its own unsigned integer arithmetic,
    negated at s = 1, 0 past 2 max_code."""
    lut = [int(v) for v in _k8_lut(fmt, frac_bits, lut_entries)[:256]]
    b = fmt.gamma.bit_length() - 1
    b_l = -1 if lut_entries is None else b - (lut_entries.bit_length() - 1)
    tab = np.zeros(768, dtype=np.int64)
    for e in range(768):
        m, s = e & 255, e >> 8
        if m > 2 * fmt.max_code:
            continue
        q, r = min(m >> b, 31), m & (fmt.gamma - 1)
        if b_l >= 0:
            t = (lut[r >> b_l] * (fmt.gamma + (1 << b_l)
                                  - (r & ((1 << b_l) - 1)))) & 0xFFFFFFFF
            v = (t >> b) >> q
        else:
            v = lut[r] >> q
        tab[e] = -v if s == 1 else v
    return tab


K8_FORMATS = [LNSFormat(bits, 1 << lg) for bits in range(2, 9)
              for lg in range(0, 13)]


@pytest.mark.parametrize("lut_entries", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("frac_bits", [16, 8, 0])
def test_k8_term_table_matches_the_datapath(lut_entries, frac_bits):
    """T[m] equals the per-product magnitude of the plain version at every
    m, at every format K8 takes (B 2..8, gamma 1..4096) and LUT kind."""
    for fmt in K8_FORMATS:
        if lut_entries is not None and lut_entries > fmt.gamma:
            continue
        tab = _k8_term_table(fmt, frac_bits, lut_entries)
        m = torch.arange(0, 2 * fmt.max_code + 1)
        if lut_entries is None:
            want = conversion.exp2_neg_exact_fixed(m, fmt.gamma, frac_bits)
        else:
            want = conversion.exp2_neg_hybrid_fixed(m, fmt.gamma,
                                                    lut_entries, frac_bits)
        n = m.numel()
        np.testing.assert_array_equal(tab[:n], want.numpy())
        np.testing.assert_array_equal(tab[256:256 + n], -want.numpy())
        np.testing.assert_array_equal(tab[512:512 + n], want.numpy())
        assert (np.abs(tab) < 1 << 17).all()      # int32 slice sums


def _k8_slice_sums(pa, pb, fmt, block_k, lut_entries=None):
    """The unclamped int32 sum of every block_k slice, through the term
    table the way the kernel indexes it (offsets of both words added)."""
    tab = torch.from_numpy(_k8_term_table(fmt, 16, lut_entries))
    wa, wb = pa.to(torch.int64), pb.to(torch.int64)
    off_a = (wa & fmt.max_code) + (((wa >> (fmt.bits - 1)) & 1) << 8)
    off_b = (wb & fmt.max_code) + (((wb >> (fmt.bits - 1)) & 1) << 8)
    K = pa.shape[1]
    return [tab[off_a[:, k0:k0 + block_k, None]
                + off_b[None, k0:k0 + block_k, :]].sum(dim=1)
            for k0 in range(0, K, block_k)]


def _k8_split_replay(sums, splits, per):
    """The kernel's split-K: each split carries its slices' collector as
    (c, lo, hi); the last block applies the splits' maps to 0 in K
    order."""
    acc = torch.zeros_like(sums[0])
    for s in range(splits):
        c = torch.zeros_like(acc)
        lo, hi = torch.full_like(acc, -SAT), torch.full_like(acc, SAT)
        for b in sums[s * per:(s + 1) * per]:
            c = c + b
            lo = torch.clamp(lo + b, -SAT, SAT)
            hi = torch.clamp(hi + b, -SAT, SAT)
        assert int(c.abs().max()) < 2 ** 31 - 2 ** 24    # int32 in-kernel
        acc = torch.minimum(torch.maximum(acc + c, lo), hi)
    return acc


def _k8_operands(M, K, N, seed, bits=8):
    rng = np.random.default_rng(seed)
    hi = 1 << bits
    return (torch.from_numpy(rng.integers(0, hi, (M, K), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, hi, (K, N), dtype=np.uint8)))


K8_REPLAY_CASES = {
    # decode's M=4 at the four smollm GEMMs, the plan's own split
    **{f"m4_{k}x{n}": (4, k, n, 16, "random") for k, n in GEMMS},
    # every word zero: every term 2^16, the collector saturates
    "saturating": (4, 256, 40, 16, "zeros"),
    # half the K all-negative products, half positive: lo/hi both move
    "saturate_both_ways": (3, 512, 24, 16, "signs"),
    # a partial last slice, and a block_k that is no multiple of 4
    "partial_last_slice": (4, 100, 33, 16, "random"),
    "odd_block_k": (5, 101, 17, 7, "random"),
}


@pytest.mark.parametrize("case", list(K8_REPLAY_CASES))
def test_k8_split_replay_matches_plain(case):
    """Per-slice sums replayed with 24-bit saturation in K order, and the
    kernel's per-split (c, lo, hi) replay at the plan's split and at every
    other split count, equal ``ref.lns_matmul_packed``."""
    M, K, N, bk, kind = K8_REPLAY_CASES[case]
    pa, pb = _k8_operands(M, K, N, seed=M + K + N)
    if kind == "zeros":
        pa, pb = torch.zeros_like(pa), torch.zeros_like(pb)
    elif kind == "signs":
        pa = torch.zeros_like(pa)
        pb = torch.zeros_like(pb)
        pb[:K // 2] = 1 << (FMT.bits - 1)
    want = ref.lns_matmul_packed(pa, pb, FMT, block_k=bk)
    sums = _k8_slice_sums(pa, pb, FMT, bk)
    acc = torch.zeros_like(sums[0])
    for b in sums:
        acc = torch.clamp(acc + b, -SAT, SAT)
    assert torch.equal(acc.to(torch.int32), want)
    plan = ops.lns_matmul_plan(M, N, K, bk)
    assert plan["splits"] * plan["slices"] >= len(sums)
    got = _k8_split_replay(sums, plan["splits"], plan["slices"])
    assert torch.equal(got.to(torch.int32), want)
    for per in range(1, len(sums) + 1):
        splits = -(-len(sums) // per)
        assert torch.equal(_k8_split_replay(sums, splits, per).to(
            torch.int32), want)
    if kind != "random":
        assert int(want.abs().max()) == SAT


@pytest.mark.parametrize("seed", range(6))
def test_k8_collector_maps_compose(seed):
    """The family acc -> clamp(acc + c, lo, hi) is closed under the
    collector's step, so any split of a slice sequence replays it: random
    sums of up to 2^23 (saturating often), random split points."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 60))
    sums = [torch.from_numpy(rng.integers(-2 ** 23, 2 ** 23, (8,)))
            for _ in range(n)]
    acc = torch.zeros(8, dtype=torch.int64)
    for b in sums:
        acc = torch.clamp(acc + b, -SAT, SAT)
    for per in sorted({1, 2, 3, int(rng.integers(1, n + 1)), n}):
        got = _k8_split_replay(sums, -(-n // per), per)
        assert torch.equal(got, acc)


@pytest.mark.parametrize("mkn", [(m, k, n) for m in (1, 4, 8, 9, 2048)
                                 for k, n in GEMMS]
                         + [(3, 4096, 40), (7, 333, 77), (2, 40000, 8),
                            (4, 0, 16), (8192, 4096, 8192)])
def test_k8_plan(mkn):
    """Skinny tiles to M=8, then wide where they make two blocks an SM,
    else mid; split-K on whole slices with none empty, each split's K
    inside the int32 budget, the split grid within four such fills."""
    M, K, N = mkn
    plan = ops.lns_matmul_plan(M, N, K)
    wide = -(-M // 128) * -(-N // 64)
    cfg = "skinny" if M <= 8 else ("wide" if wide >= 264 else "mid")
    bm, bn = {"skinny": (4, 256), "wide": (128, 64), "mid": (64, 64)}[cfg]
    assert plan["cfg"] == cfg
    assert (plan["grid_m"], plan["grid_n"]) == (-(-M // bm), -(-N // bn))
    slices = -(-K // 16)
    tiles = plan["grid_m"] * plan["grid_n"]
    assert plan["splits"] >= 1
    if plan["splits"] > 1:
        assert cfg != "wide"
        assert plan["splits"] <= (16 if cfg == "skinny" else 8)
        assert tiles * plan["splits"] <= 4 * 264
        assert plan["slices"] * 16 <= 16000
        if cfg != "skinny":
            assert plan["slices"] >= 32
    assert (plan["splits"] - 1) * plan["slices"] < max(slices, 1)
    assert plan["splits"] * plan["slices"] >= slices
    assert plan["repl"] == (1 if cfg == "skinny" else 32)


def test_k8_plan_at_the_measured_shapes():
    """The plan the sweep chose (PERF.md): decode's M=4 in 12-16 skinny
    splits, M=2048 on mid tiles unsplit at K=576 and in 3 splits at
    K=1536, wide tiles at 2048x576x1536."""
    got = {(m, k, n): ops.lns_matmul_plan(m, n, k)
           for m in (4, 2048) for k, n in GEMMS}
    assert [got[(4, k, n)]["splits"] for k, n in GEMMS] == [12, 12, 12, 16]
    assert [(got[(2048, k, n)]["cfg"], got[(2048, k, n)]["splits"])
            for k, n in GEMMS] == [("mid", 1), ("mid", 1), ("wide", 1),
                                   ("mid", 3)]


# ---------------------------------------------------------------------------
# K7: the re-grid four bytes at a time (lns_requant.cu `regrid4`) and the
# 16-byte units of a launch, modelled in numpy uint32 arithmetic


def _regrid4(w, src, dst):
    """numpy model of `regrid4` on uint32 words (four packed bytes)."""
    u32 = np.uint32
    up, s = ops.regrid_shift(src, dst)
    src_max, dst_max = src.max_code, dst.max_code
    ones = u32(0x01010101)
    dmax4 = u32(dst_max * 0x01010101)

    def gt_mask4(a, b):
        d = ((a | u32(0x80808080)) - b - ones) & u32(0x80808080)
        return (d >> u32(7)) * u32(0xFF)

    sign = (w >> u32(src.bits - 1)) & ones
    c = w & u32(src_max * 0x01010101)
    if up:
        sat = gt_mask4(c, u32((dst_max >> s) * 0x01010101))
        r = (sat & dmax4) | ((c & ~sat) << u32(s))
    else:
        r = (((c >> u32(s)) & u32((0xFF >> s) * 0x01010101))
             + ((c >> u32(s - 1)) & ones))
        sat = gt_mask4(r, dmax4)
        r = (sat & dmax4) | (r & ~sat)
    return (sign << u32(dst.bits - 1)) | r


_K7_PAIRS = [((8, 8), b) for b in (2, 3, 4, 5, 6, 7, 8)] + [
    ((6, 2), 8), ((8, 1), 8), ((8, 4), 3), ((7, 8), 2), ((8, 128), 2),
    ((2, 1), 8), ((4, 2), 7), ((8, 8), 8)]


@pytest.mark.parametrize("src,bits", _K7_PAIRS)
def test_k7_regrid_four_bytes_at_a_time_matches_plain(src, bits):
    """Every byte value in every lane of a word, up- and down-grids
    (shifts 0..7 up, 1..8 down, the clamped ones too): the words of
    ``ref.requant_pack``; no lane carries into its neighbour."""
    src = LNSFormat(*src)
    dst = src.with_bits(bits)
    b = np.arange(256, dtype=np.uint32)
    rng = np.random.default_rng(bits)
    for lane in range(4):
        others = rng.integers(0, 256, (3, 256)).astype(np.uint32)
        lanes = list(others)
        lanes.insert(lane, b)
        w = sum(x << np.uint32(8 * i) for i, x in enumerate(lanes))
        got = _regrid4(w.astype(np.uint32), src, dst)
        for i, x in enumerate(lanes):
            want = ref.requant_pack(torch.from_numpy(x.astype(np.uint8)),
                                    src, dst).numpy()
            np.testing.assert_array_equal(
                ((got >> np.uint32(8 * i)) & np.uint32(0xFF)).astype(
                    np.uint8), want)


def _k7_units(ptr, n):
    """The 16-byte units of a leaf at address ``ptr``: (lo, hi, vector)
    byte ranges of the leaf, as `requant_kernel` cuts them."""
    head = ptr % 16
    units = (head + n + 15) // 16 if n else 0
    out = []
    for u in range(units):
        lo, hi = u * 16 - head, u * 16 - head + 16
        vec = lo >= 0 and hi <= n
        out.append((max(lo, 0), min(hi, n), vec))
    return out


@pytest.mark.parametrize("ptr,n", [(0, 1 << 12), (3, 1000003), (17, 15),
                                   (0, 17), (15, 1), (8, 0), (1, 31)])
def test_k7_units_cover_each_byte_once(ptr, n):
    """Units cover every byte of a leaf exactly once; only the first and
    the last unit can take the byte path, and a vector unit starts on a
    16-byte boundary of the address."""
    units = _k7_units(ptr, n)
    seen = np.zeros(n, np.int64)
    for i, (lo, hi, vec) in enumerate(units):
        seen[lo:hi] += 1
        assert vec or i in (0, len(units) - 1)
        assert not vec or (ptr + lo) % 16 == 0
    assert (seen == 1).all()


# ---------------------------------------------------------------------------
# K6: a row split over a cluster of blocks, each block's chunk in a scalar
# head, 16-byte loads and a scalar tail, merged in rank order
# (sampler.cu), modelled on the plain values


def _k6_split(v, blocks, residue):
    """First-max-wins argmax of ``v`` as the kernel computes it: the row
    starts ``residue`` floats past a 16-byte boundary, cut into
    ``blocks`` chunks of a multiple of 4; in each chunk a thread keeps
    (max, first index) over a head, float4 groups and a tail, threads
    merge, then blocks merge in rank order."""
    V = v.size
    chunk = -(-V // blocks)
    chunk = (chunk + 3) & ~3

    def better(a, b):
        return b if (b[0] > a[0] or (b[0] == a[0] and b[1] < a[1])) else a

    best = (-np.inf, V)
    for rank in range(blocks):
        lo = min(V, rank * chunk)
        hi = min(V, lo + chunk)
        head = min((4 - (residue + lo) % 4) % 4, hi - lo)
        part = (-np.inf, V)
        groups = [range(lo, lo + head)]
        v0 = lo + head
        n4 = (hi - v0) // 4
        groups += [range(v0 + 4 * j, v0 + 4 * j + 4) for j in range(n4)]
        groups.append(range(v0 + 4 * n4, hi))
        for g in reversed(groups):          # any order: the merge decides
            for i in g:
                part = better(part, (v[i], i))
        best = better(best, part)
    return best[1] if best[1] < V else 0


@pytest.mark.parametrize("V,blocks,residue", [
    (49152, 8, 0), (49152, 16, 0), (1000, 4, 1), (37, 8, 3), (5, 16, 2),
    (49152, 1, 2)])
def test_k6_split_argmax_is_the_first_maximum(V, blocks, residue):
    """Ties within a float4, across float4s, across blocks and at the
    head and tail, -inf rows: the split's merge gives torch.argmax's first
    maximum under any split (nothing is summed)."""
    rng = np.random.default_rng(V + blocks)
    v = rng.integers(-3, 4, V).astype(np.float32)  # many ties
    for _ in range(6):
        want = int(np.argmax(v))
        assert _k6_split(v, blocks, residue) == want
        assert int(torch.argmax(torch.from_numpy(v))) == want
        v[rng.integers(0, V)] = v.max()            # add a later tie
        v[rng.integers(0, V)] = v.max() + 1        # and a new maximum
    assert _k6_split(np.full(V, -np.inf, np.float32), blocks, residue) == 0


def test_k6_plan():
    """Blocks a row: a power of two up to ``_K6_MAX_BLOCKS``, each with
    at least ``_K6_MIN_CHUNK`` logits, at most ``_K6_FILL`` blocks in
    all; the decode (4 rows) and verify (16 rows) batches of smollm-135m
    take the largest cluster."""
    for B, V in ((4, 49152), (16, 49152), (64, 49152), (1, 256), (3, 4096),
                 (64, 1000)):
        p = ops.fused_sample_plan(B, V)
        b = p["blocks"]
        assert b & (b - 1) == 0 and 1 <= b <= ops._K6_MAX_BLOCKS
        assert b == 1 or (V >= b * ops._K6_MIN_CHUNK
                          and B * b <= ops._K6_FILL)
        assert p["threads"] % 32 == 0
    assert ops.fused_sample_plan(4, 49152)["blocks"] == ops._K6_MAX_BLOCKS
    assert ops.fused_sample_plan(16, 49152)["blocks"] == ops._K6_MAX_BLOCKS
