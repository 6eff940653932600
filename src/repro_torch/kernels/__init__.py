"""The port's kernels: plain versions (``ref``), CUDA wrappers (``ops``)
and the device-based ``dispatch``. ``lns_matmul`` is the bit-exact
datapath matmul on real inputs (``repro.kernels.lns_matmul``); it is
``dispatch.lns_matmul``, resolved on first use so that importing a
submodule such as ``ref`` does not load the wrapper layer."""

__all__ = ["lns_matmul"]


def __getattr__(name):
    if name == "lns_matmul":
        from repro_torch.kernels.dispatch import lns_matmul
        return lns_matmul
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
