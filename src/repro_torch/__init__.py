"""PyTorch/CUDA port of the LNS-Madam serving path (see ``repro`` for the
JAX reference). Entry points run on ``"cuda"`` unless given ``device="cpu"``."""
