"""Build, load and count the port's CUDA kernels.

Every kernel lives in ``csrc/*.cu`` behind a plain C interface. At first
use the sources are compiled for Hopper with ``nvcc`` (one process per
source, all started together, then one link) into a shared library under
``build/repro_torch/<hash of the sources and flags>/`` at the root of the
checkout, and loaded with ``ctypes``. The one ``libcuda`` function a
kernel needs (``cuTensorMapEncodeTiled``, for TMA) is looked up at run
time with ``dlsym`` in the ``libcuda.so.1`` the process holds, so nothing
links ``libcuda``. Nothing is built or imported at
module import: the CPU tests import every module on a machine without
``nvcc``.

``LAUNCHES`` counts wrapper calls that launched a kernel, by name: one per
call, where the wrapper launches and nowhere else (a ``spec_verify`` call
launches two kernels, its split pass and its final reduction, and counts
one). A run can so show that its path went through the kernels
(``reset_launches`` before, read after). ``WKV_FORMS`` splits
``rwkv_wkv``'s count by the form launched: "none" (zero state), "all"
(every position's state, the verify window) and "last" (prefill).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"spec_verify": 0, "paged_decode": 0, "paged_write": 0,
            "paged_latent": 0, "flash_attention": 0, "rwkv_wkv": 0,
            "decode_attention": 0}
WKV_FORMS = {"none": 0, "all": 0, "last": 0}

_LIB = None
_FNS: dict = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, WKV_FORMS):
        for name in counts:
            counts[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile ``csrc`` into ``libkernels.so`` unless this exact source set
    was built before; returns the library's path. ``build.log`` beside it
    keeps ptxas's register and shared-memory report."""
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cus + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libkernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for cu in cus:
        obj = out_dir / (cu.stem + ".o")
        procs.append((cu, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(cu), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cu, obj, p in procs:
        text, _ = p.communicate()
        log.append(f"== {cu.name} (rc {p.returncode})\n{text}")
        if p.returncode != 0:
            failed.append(cu.name)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out_dir / f"libkernels.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", str(tmp), *[str(o) for _, o, _ in procs], "-ldl"],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build()))
    return _LIB


def bind(name: str, argtypes, restype=ctypes.c_int):
    """The C function ``name`` of the kernel library with its signature
    declared (pointers and the stream as ``c_void_p``)."""
    if name not in _FNS:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FNS[name] = fn
    return _FNS[name]


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_status(name: str, status: int) -> None:
    """Raise on a non-zero ``cudaGetLastError`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
