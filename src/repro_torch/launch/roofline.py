"""Three-term roofline of a dry-run cell on H100 cards.

The constants are the NVIDIA H100 SXM data sheet's, not measurements:
989e12 dense bf16 FLOP/s (tensor cores), 67e12 f32 FLOP/s (CUDA cores),
3.35e12 B/s of HBM3, NVLink 450e9 B/s a direction (of its 900 GB/s), and
50e9 B/s a card between hosts (one 400 Gb/s NDR port a card).
``chip_smoke.py``'s bound column divides by the same numbers.

Terms (seconds a step, a card), from the port's own counts
(``launch.cost``, ``distributed.collectives``):

    T_compute    = flops_per_device / 989e12
    T_memory     = bytes_per_device / 3.35e12
    T_collective = nvlink_bytes / 450e9 + network_bytes / 50e9

A collective's bytes go to NVLink where its group lies inside one host
and to the network where it spans hosts; the row carries both parts.
``model_flops`` and the report's properties are the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["PEAK_FLOPS", "F32_FLOPS", "HBM_BW", "NVLINK_BW", "NET_BW",
           "HBM_BYTES", "RooflineReport", "analyze", "model_flops"]

PEAK_FLOPS = 989e12   # bf16 / card, dense
F32_FLOPS = 67e12     # f32 outside the tensor cores
HBM_BW = 3.35e12      # B/s
NVLINK_BW = 450e9     # B/s a direction
NET_BW = 50e9         # B/s a card between hosts
# an H100 80 GB's torch.cuda.get_device_properties(0).total_memory
HBM_BYTES = 85_017_493_504

@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops_global: float
    peak_bytes_per_device: Optional[float] = None
    collectives: Optional[Dict[str, int]] = None
    nvlink_bytes: float = 0.0
    network_bytes: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS over the global counted FLOPs."""
        counted = self.flops_per_device * self.chips
        return self.model_flops_global / counted if counted else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful FLOPs a second against the peak, at the modelled step
        time ``max(T_c, T_m, T_coll)``."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        return (self.model_flops_global / self.chips / t) / PEAK_FLOPS

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.collective_bytes_per_device,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops_global,
            "useful_fraction": self.useful_fraction,
            "roofline_fraction": self.roofline_fraction,
            "peak_bytes_per_device": self.peak_bytes_per_device,
            "collectives": self.collectives,
            "coll_bytes_nvlink": self.nvlink_bytes,
            "coll_bytes_network": self.network_bytes,
            "t_collective_nvlink_s": self.nvlink_bytes / NVLINK_BW,
            "t_collective_network_s": self.network_bytes / NET_BW,
        }


def model_flops(cfg, spec, kind: str) -> float:
    """MODEL_FLOPS: 6·N·D to train (forward and backward), 2·N·D to
    serve; N the active parameters (MoE), D the tokens of the step."""
    n = cfg.active_params_count()
    if kind == "train":
        return 6.0 * n * spec.global_batch * spec.seq_len
    if kind == "prefill":
        return 2.0 * n * spec.global_batch * spec.seq_len
    return 2.0 * n * spec.global_batch     # decode: a token a sequence


def analyze(arch: str, shape: str, mesh_name: str, chips: int, cost: Dict,
            coll: Dict, within_host: Dict[str, bool], mf: float,
            peak_bytes: Optional[float] = None) -> RooflineReport:
    """The report of one cell: ``cost`` a cost mode's ``flops`` and
    ``bytes``; ``coll`` ``collectives.byte_counts()``; ``within_host``
    whether each of its axes labels lies inside one host."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes", 0.0))
    nv = net = 0.0
    for axes, kinds in coll.get("by_axis", {}).items():
        n = float(sum(kinds.values()))
        if within_host.get(axes, False):
            nv += n
        else:
            net += n
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=byts,
        collective_bytes_per_device=nv + net,
        t_compute=flops / PEAK_FLOPS, t_memory=byts / HBM_BW,
        t_collective=nv / NVLINK_BW + net / NET_BW,
        model_flops_global=mf, peak_bytes_per_device=peak_bytes,
        collectives={k: int(v) for k, v in coll.get("bytes", {}).items()
                     if v},
        nvlink_bytes=nv, network_bytes=net)
