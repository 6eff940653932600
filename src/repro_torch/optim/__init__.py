"""Optimizers of the port: LNS-Madam and its baselines, as
``repro.optim``."""
from repro_torch.optim.baselines import adamw, quantized_update, sgd
from repro_torch.optim.madam import (LNSWeight, MadamConfig, MadamState,
                                     attach_proxies, grad_proxies,
                                     init_lns_params, is_lns_weight,
                                     madam_fp, madam_lns, materialize)

__all__ = [
    "LNSWeight", "MadamConfig", "MadamState", "init_lns_params",
    "is_lns_weight", "materialize", "grad_proxies", "attach_proxies",
    "madam_lns", "madam_fp", "sgd", "adamw", "quantized_update",
]
