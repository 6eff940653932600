"""Quickstart of the PyTorch/CUDA port: the LNS-Madam pipeline end to end.

The four steps of ``examples/quickstart.py``, on ``repro_torch``:

1. quantize a tensor onto the multi-base LNS grid (paper Eq. 3)
2. run a quantized GEMM through the STE machinery (paper §3)
3. train a small LM with weights stored natively as packed LNS words and
   updated multiplicatively (paper §4, Algorithm 1): no f32 master copy
4. run the bit-exact Fig.-6 datapath: the hand-written kernel on the
   card, its plain PyTorch version with ``--device cpu``

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.lns import LNSFormat, lns_quantize
from repro_torch.core.quantizer import QuantConfig, qeinsum
from repro_torch.kernels import lns_matmul
from repro_torch.optim.madam import MadamConfig
from repro_torch.training.data import SyntheticLM
from repro_torch.training.steps import build_train_step, init_train_state

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="'cpu' runs the plain versions of the kernels")
ap.add_argument("--steps", type=int, default=10)
args = ap.parse_args()
dev = torch.device(args.device)
gen = torch.Generator(device=dev).manual_seed(0)

# --- 1. the multi-base LNS format (B=8 bits, gamma=8 -> range (0, 15.875))
fmt = LNSFormat(bits=8, gamma=8)
x = torch.randn(4, generator=gen, device=dev)
print("x       ", x.tolist())
print("Q_log(x)", lns_quantize(x, fmt).tolist(),
      f"(grid step 2^(1/{fmt.gamma}))")

# --- 2. a quantized GEMM: Q_A/Q_W on inputs, Q_E on the backward gradient
qcfg = QuantConfig.lns_madam()
a = torch.randn(8, 32, generator=gen, device=dev)
w = torch.randn(32, 16, generator=gen, device=dev)
y = qeinsum("bi,ij->bj", a, w, qcfg)
print("\nqeinsum max |err| vs f32:", float((y - a @ w).abs().max()))

# --- 3. LNS-native training: the weights ARE packed exponent words
cfg = get_smoke_config("granite-8b")
mcfg = MadamConfig(lr=2.0 ** -6)
state = init_train_state(cfg, mcfg, device=dev)
leaf = state.params["period"]["pos0"]["mlp"]["up"]
print(f"\nweight storage: packed {leaf.packed.dtype} "
      f"({leaf.packed.element_size()} B/elem words), scale "
      f"{tuple(leaf.scale.shape)}: no float weights")
step = build_train_step(cfg, qcfg, mcfg)
for i, batch in zip(range(args.steps), SyntheticLM(cfg, batch=8, seq=32)):
    state, metrics = step(state, batch)
    if i % 3 == 0:
        print(f"step {i}: loss {float(metrics['loss']):.4f}")

# --- 4. the bit-exact hardware datapath (Fig. 6): K8 on the card, its
# plain version on the CPU (integer exponent adds + shift + LUT)
out = lns_matmul(a, w, fmt)
print(f"\nbit-exact datapath ({'K8' if dev.type == 'cuda' else 'plain'}) "
      f"max |err| vs f32:", float((out - a @ w).abs().max()))
print("\nok")
