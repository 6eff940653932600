"""Serving kernels: plain versions (``ref``), CUDA wrappers (``ops``) and
the device-based ``dispatch``."""
