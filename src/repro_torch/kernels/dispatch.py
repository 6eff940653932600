"""One dispatch point for the kernels, chosen by tensor device.

* A CPU tensor goes to the plain PyTorch version (``kernels.ref``).
* A CUDA tensor launches the hand-written kernel (``kernels.ops``), or the
  wrapper raises. There is no fallback from a CUDA tensor to the plain
  version, and no setting that reroutes one.
* A ``meta`` tensor goes to the kernel's shape function
  (``kernels.meta``): its outputs as ``meta`` tensors, nothing computed.
  A dry run traces a step this way. Nothing else reaches it.

Any other device raises. The JAX package's backend precedence chain
(``configure()``, per-call argument, env var, platform) has no counterpart
here: the caller picks the device, and the device picks the path.

Every entry point checks one module global, ``kernel_stats.active()``;
with a collector enabled it runs the implementation the route chose
through ``kernel_stats.observe``, which counts and times it and never
changes the route. With a cost sink active (``kernels.costs``, a dry
run's cost mode), or on ``meta``, each call is charged its kernel's
cost, from its arguments' shapes (:func:`_call`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.lns import (LNSFormat, compute_scale, lns_encode,
                                  lns_pack, lns_word_dtype)
from repro_torch.kernels import costs, meta, ops, ref
from repro_torch.kernels.madam_stats import madam_stats_dict, requant_spec
from repro_torch.obs import kernel_stats

__all__ = ["route", "encode_pack", "qmatmul", "qmatmul_decode",
           "paged_attend", "fused_sample", "fused_sample_seeded",
           "madam_step", "madam_step_unpacked", "requant_pack",
           "requant_pack_many",
           "lns_matmul_packed", "lns_matmul"]


_ROUTES = {"cpu": "plain", "cuda": "kernel", "meta": "meta"}


def route(t) -> str:
    """``"plain"`` for a CPU tensor, ``"kernel"`` for a CUDA one,
    ``"meta"`` for a ``meta`` one."""
    kind = t.device.type
    if kind not in _ROUTES:
        raise ValueError(f"no kernel path for device {t.device}")
    return _ROUTES[kind]


def _pick(backend: str, name: str):
    """The implementation of kernel ``name`` on ``backend``."""
    return getattr({"kernel": ops, "plain": ref, "meta": meta}[backend],
                   name)


def _call(op: str, backend: str, bits: int, probe, cost_fn, impl, *args,
          **kwargs):
    """Run ``impl``: charged ``cost_fn()`` (a ``costs.Cost``) where a cost
    sink is active or the route is ``meta``, counted and timed where
    ``kernel_stats`` is on."""
    if backend == "meta" or costs.active() is not None:
        impl = costs.charged(op, backend == "meta", cost_fn, impl)
    if kernel_stats.active() is not None:
        return kernel_stats.observe(op, backend, bits, probe, impl, *args,
                                    **kwargs)
    return impl(*args, **kwargs)


def encode_pack(x: torch.Tensor, fmt: LNSFormat,
                scale_axis: Optional[int] = None,
                scale: Optional[torch.Tensor] = None):
    """K1: Q_log-encode a 2-D tensor -> ``(packed (R,C), scale (R,1))``,
    against its own absmax scale or a given one (``(1, 1)`` per tensor,
    ``(R, 1)`` per row)."""
    backend = route(x)
    args = (x, fmt, scale_axis) + (() if scale is None else (scale,))
    cost = lambda: costs.encode_pack(
        x.shape[0], x.shape[1], x.element_size(),
        lns_word_dtype(fmt).itemsize,
        None if scale is None else scale.numel())
    return _call("encode_pack", backend, fmt.bits, x, cost,
                 _pick(backend, "encode_pack"), *args)


def qmatmul(pa: torch.Tensor, pb: torch.Tensor, fmt: LNSFormat,
            scale_a: Optional[torch.Tensor] = None,
            scale_b: Optional[torch.Tensor] = None, *,
            compute_dtype=torch.bfloat16,
            out_dtype=torch.float32) -> torch.Tensor:
    """K2: packed ``pa (M,K) @ pb (K,N)`` -> ``out_dtype`` (f32 or bf16),
    row/column scales."""
    backend = route(pa)
    M, K = pa.shape
    cost = lambda: costs.qmatmul(
        M, K, pb.shape[1], out_dtype.itemsize,
        word_bytes=pa.element_size(),
        scales=scale_a is not None or scale_b is not None)
    return _call("qmatmul", backend, fmt.bits, pa, cost,
                 _pick(backend, "qmatmul"), pa, pb, fmt, scale_a, scale_b,
                 compute_dtype=compute_dtype, out_dtype=out_dtype)


def qmatmul_decode(pa: torch.Tensor, pb: torch.Tensor, fmt: LNSFormat):
    """K2's decode pass: packed operands -> padded K-major bf16
    ``(ad, bt)``, as the wgmma path multiplies them."""
    backend = route(pa)
    (M, K), N = pa.shape, pb.shape[1]

    def cost():
        a, b = meta.padded(M, K, N)
        return costs.qmatmul_decode(M, K, N, a[0] * a[1], b[0] * b[1],
                                    pa.element_size())
    return _call("qmatmul_decode", backend, fmt.bits, pa, cost,
                 _pick(backend, "qmatmul_decode"), pa, pb, fmt)


def paged_attend(q, kp, vp, k_scale, v_scale, block_table, lengths, *,
                 fmt: Optional[LNSFormat] = None,
                 softcap: Optional[float] = None,
                 sm_scale: float) -> torch.Tensor:
    """K5: attend ``q (B,S,h,hd)`` over a paged pool -> f32."""
    backend = route(q)

    def cost():
        B, S, H, HD = q.shape
        page, mp = kp.shape[1], block_table.shape[1]
        # the lengths the rows reach (a host read), or on meta every
        # position of the block table: the most the call could need
        ln = ([mp * page] * B if backend == "meta" else
              [int(n) for n in lengths.tolist()])
        return costs.paged_attend(B, S, H, HD, kp.shape[2], page, mp, ln,
                                  q_bytes=q.element_size(),
                                  pool_bytes=kp.element_size(),
                                  packed=fmt is not None)
    return _call("paged_attend", backend,
                 fmt.bits if fmt is not None else 0, q, cost,
                 _pick(backend, "paged_attend"), q, kp, vp, k_scale,
                 v_scale, block_table, lengths, fmt=fmt, softcap=softcap,
                 sm_scale=sm_scale)


def fused_sample(logits: torch.Tensor, gumbel: Optional[torch.Tensor],
                 temp: Optional[torch.Tensor]) -> torch.Tensor:
    """K6: ``logits (B,V)`` -> ``(B,)`` int32 tokens."""
    backend = route(logits)
    cost = lambda: costs.fused_sample(
        *logits.shape, "greedy" if gumbel is None else "noise-in",
        logits.element_size())
    return _call("fused_sample", backend, 0, logits, cost,
                 _pick(backend, "fused_sample"), logits, gumbel, temp)


def fused_sample_seeded(logits: torch.Tensor, temp, seed, step, *,
                        noise_out: bool = False):
    """K6, seeded: ``logits (B,V)`` and host rows ``temp`` (f32), ``seed``
    (uint32), ``step`` (int32) -> ``(B,)`` int32 tokens, the gumbel noise
    of ``ref.gumbel_noise`` drawn in the kernel; with ``noise_out`` also
    that noise ``(B,V)``."""
    backend = route(logits)
    cost = lambda: costs.fused_sample(*logits.shape, "seeded",
                                      logits.element_size())
    return _call("fused_sample_seeded", backend, 0, logits, cost,
                 _pick(backend, "fused_sample_seeded"), logits, temp, seed,
                 step, noise_out=noise_out)


def requant_pack(packed: torch.Tensor, src: LNSFormat,
                 dst: LNSFormat) -> torch.Tensor:
    """K7: re-grid packed words of any rank from ``src`` to ``dst`` bits
    (the self-speculative draft view; integer-only, scales untouched)."""
    backend = route(packed)
    cost = lambda: costs.requant_pack(packed.numel(), packed.element_size(),
                                      lns_word_dtype(dst).itemsize)
    return _call("requant_pack", backend, dst.bits, packed, cost,
                 _pick(backend, "requant_pack"), packed, src, dst)


def requant_pack_many(leaves: Sequence[torch.Tensor], src,
                      dst) -> List[torch.Tensor]:
    """K7 over leaves that share ``(src, dst)``: one launch on the card
    (``ops.K7_MAX_LEAVES`` leaves at most), the plain version of each on
    the CPU. The leaves share one kind of device."""
    kinds = {route(p) for p in leaves}
    if len(kinds) != 1:
        raise ValueError(f"requant_pack_many: leaves must share one kind of "
                         f"device, got {sorted(kinds) or 'no leaves'}")
    backend, = kinds
    d0 = dst if isinstance(dst, LNSFormat) else dst[0]
    cost = lambda: costs.requant_pack(
        sum(p.numel() for p in leaves), leaves[0].element_size(),
        lns_word_dtype(d0).itemsize)
    return _call("requant_pack_many", backend, d0.bits, leaves[0], cost,
                 _pick(backend, "requant_pack_many"), leaves, src, dst)


def madam_step(packed: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
               count: int, fmt: LNSFormat, *, lr: float, beta: float = 0.999,
               eps: float = 1e-30, with_stats: bool = False,
               requant_fmt: Optional[LNSFormat] = None):
    """K3 (K4 with ``with_stats``): the fused Algorithm-1 step on a packed
    leaf of rank >= 2, folded to ``(-1, last)``. ``count`` is the
    post-increment step (a host int, so reading it costs no device sync).
    Returns ``(new_packed, new_v)``, plus the dict of
    ``madam_stats.MADAM_STAT_KEYS`` with ``with_stats``."""
    backend = route(packed)
    shape = packed.shape
    if len(shape) < 2:
        raise ValueError(f"madam_step needs a >=2-D leaf, got {tuple(shape)}")
    p2 = packed.reshape(-1, shape[-1])
    g2 = g.reshape(p2.shape)
    v2 = v.reshape(p2.shape)
    bc = ref.bias_correction(beta, count)
    kw = dict(lr=lr, beta=beta, eps=eps)
    impl = _pick(backend, "madam_step_stats" if with_stats
                 else "madam_step")
    if with_stats:
        kw["requant"] = requant_spec(fmt, requant_fmt)
    cost = lambda: costs.madam_step(p2.numel(), p2.element_size(),
                                    g2.element_size())
    out = _call("madam_step", backend, fmt.bits, packed, cost, impl, p2, g2,
                v2, bc, fmt, **kw)
    if not with_stats:
        np_, nv = out
        return np_.reshape(shape), nv.reshape(shape)
    np_, nv, vec = out
    return (np_.reshape(shape), nv.reshape(shape),
            madam_stats_dict(vec, p2.numel(), fmt))


def madam_step_unpacked(code: torch.Tensor, sign: torch.Tensor,
                        g: torch.Tensor, v: torch.Tensor, count: int,
                        fmt: LNSFormat, *, lr: float, beta: float = 0.999,
                        eps: float = 1e-30):
    """K9: the Algorithm-1 step on a 2-D leaf kept as ``(code, sign)``
    (the counterpart of ``repro.kernels.ops.madam_step``); ``count`` is
    the post-increment step. Returns ``(new_code, new_v)``."""
    backend = route(code)
    bc = ref.bias_correction(beta, count)
    cost = lambda: costs.madam_step_unpacked(code.numel(), code.element_size(),
                                             g.element_size())
    return _call("madam_step_unpacked", backend, fmt.bits, code, cost,
                 _pick(backend, "madam_step_unpacked"), code, sign, g, v, bc,
                 fmt, lr=lr, beta=beta, eps=eps)


def lns_matmul_packed(pa: torch.Tensor, pb: torch.Tensor, fmt: LNSFormat, *,
                      frac_bits: int = 16, lut_entries: Optional[int] = None,
                      block_k: int = 16) -> torch.Tensor:
    """K8: the Fig.-6 integer datapath on packed ``pa (M,K) @ pb (K,N)``
    -> int32 partial sums in ``frac_bits`` fixed point."""
    backend = route(pa)
    cost = lambda: costs.lns_matmul_packed(*pa.shape, pb.shape[1], block_k,
                                           pa.element_size())
    return _call("lns_matmul_packed", backend, fmt.bits, pa, cost,
                 _pick(backend, "lns_matmul_packed"), pa, pb, fmt,
                 frac_bits=frac_bits, lut_entries=lut_entries,
                 block_k=block_k)


def lns_matmul(a: torch.Tensor, b: torch.Tensor, fmt: LNSFormat, *,
               frac_bits: int = 16, lut_entries: Optional[int] = None,
               block_k: int = 16) -> torch.Tensor:
    """The datapath matmul on real 2-D inputs, as
    ``repro.kernels.ops.lns_matmul``: per-tensor pow2 scales, Q_log encode
    and pack of both operands, K8, then ``out · s_a·s_b / 2**frac_bits``
    in f32 (exact: the scales are powers of two and |out| < 2**24).

    K is padded to a multiple of ``block_k`` with ``max_code`` words
    (positive, smallest magnitude), exactly as the JAX function pads it.
    K8 itself needs no padding, but a pad pair is not always zero: at
    B=8, γ<=8 its product exponent 254 shifts it out (q = 31), while at
    B=4, γ=4 each pad pair adds 5792 (2**-3.5 in Q.16) to the last block.
    Padding the same way keeps the result equal to JAX's for every
    format."""
    if kernel_stats.active() is not None:
        return kernel_stats.observe(
            "lns_matmul", route(a), fmt.bits, a, _lns_matmul, a, b, fmt,
            frac_bits=frac_bits, lut_entries=lut_entries, block_k=block_k)
    return _lns_matmul(a, b, fmt, frac_bits=frac_bits,
                       lut_entries=lut_entries, block_k=block_k)


def _lns_matmul(a, b, fmt, *, frac_bits, lut_entries, block_k):
    sa, sb = compute_scale(a), compute_scale(b)
    pa = lns_pack(*lns_encode(a, fmt, sa), fmt)
    pb = lns_pack(*lns_encode(b, fmt, sb), fmt)
    pad = -a.shape[1] % block_k
    if pad:
        pa = F.pad(pa, (0, pad), value=fmt.max_code)
        pb = F.pad(pb, (0, 0, 0, pad), value=fmt.max_code)
    out = lns_matmul_packed(pa.contiguous(), pb.contiguous(), fmt,
                            frac_bits=frac_bits, lut_entries=lut_entries,
                            block_k=block_k)
    return out.to(torch.float32) * (sa * sb) / (1 << frac_bits)
