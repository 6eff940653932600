"""Build the CUDA kernels under ``csrc/`` into one shared library.

The sources have a plain C interface and are compiled with ``nvcc`` for
``sm_90a`` (Hopper), one ``nvcc`` process per source, all started
together, then linked into ``build/repro_torch/`` at the repository root
and loaded with ``ctypes``. The library's file name carries a hash of the
sources and flags, so an edited source builds anew and an unchanged one
loads the library already built. Nothing here runs at import time: the
first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional

__all__ = ["CSRC", "build", "library", "build_dir"]

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false: no implicit mul+add contraction, so each kernel rounds in
# the same places as its plain version (explicit fmaf calls stay fused)
FLAGS = ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    # -Xptxas -v only reports: it changes no byte of the library
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(ptxas_verbose: bool = False) -> Path:
    """Compile and link the kernels if this exact source set has not been
    built yet; returns the library path. ``ptxas_verbose`` prints each
    kernel's registers, shared memory and spills."""
    extra = ["-Xptxas", "-v"] if ptxas_verbose else []
    out_dir = build_dir()
    lib_path = out_dir / f"librepro_torch_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH, *FLAGS, *extra, "-I", str(CSRC), "-c",
                   str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            if log.strip() and (proc.returncode or ptxas_verbose):
                print(f"[nvcc {src.name}]\n{log}", flush=True)
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    print(f"built {lib_path.name} in {time.monotonic() - t0:.1f}s", flush=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
