"""Build and load the hand-written CUDA kernels of sfft_tpu_torch/csrc.

All ``csrc/*.cu`` files (with the ``*.cuh`` headers they share) compile with
nvcc (one process per source, all started together) and link into one
shared library with a plain C interface (no PyTorch headers, so a build takes seconds), placed in
``sfft_tpu_torch/_build/`` under a name that carries a hash of the sources
and flags: an edited source builds anew at its first use. The library is
loaded with ctypes. Every C entry takes its tensors as raw device pointers
and PyTorch's current stream, launches without synchronising, and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.

Nothing here runs at import: ``import sfft_tpu_torch`` works on machines
without nvcc or a GPU, and the kernel wrappers reach this module only for
CUDA tensors.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry -> argument types (pointers and the stream as void*, sizes as int
# or long long)
_SIGNATURES = {
    "sfft_slice_pairs": [_P, _I, _I, _I, _I, _I, _L, _I, _L, _I, _I, _P],
    "sfft_slice_pairs_absmax": [_P, _I, _I, _I, _I, _P, _P, _P],
    "sfft_slice_pairs_rowmax": [_P, _L, _I, _I, _P, _P, _P],
    "sfft_slice_rows_f64": [_P, _L, _P, _P, _P, _P, _L, _L, _L, _I, _I, _L, _P],
    "sfft_slice_vec_f64": [_P, _P, _P, _L, _L, _I, _P],
    "sfft_slice_triple_f32": [_P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _I, _P],
    "sfft_moments_f64": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _L, _P],
    "sfft_corr_window_c64": [_P] * 8 + [_I] * 11 + [_P],
    "sfft_corr_window_c128": [_P] * 8 + [_I] * 11 + [_P],
    "sfft_fdiff_model_c64": [_P] * 8 + [_I] * 10 + [ctypes.c_double, _P],
    "sfft_fdiff_model_c128": [_P] * 8 + [_I] * 10 + [ctypes.c_double, _P],
    "sfft_sliced_epilogue": [_P, _P],
    "sfft_pair_products": [_P, _P],
    "sfft_pair_model": [_P, _I, _P],
    "sfft_pair_poly": [_I, _I] + [_P] * 8 + [_I] * 4 + [_L] * 4 + [_P],
    "sfft_corr_direct": [_P] * 4 + [_I] * 14 + [_P],
    "sfft_conv_direct": [_P] * 8 + [_I] * 10 + [ctypes.c_double, _P],
    "sfft_cuda_error_string": [_I],
}

_lib = None
_lock = threading.Lock()


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of sfft_tpu_torch "
                           "need the CUDA toolkit (set CUDA_HOME)")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libsfft_kernels_{h.hexdigest()[:16]}.so")


def build_report_path() -> str:
    """The compiler's report of the library's build (ptxas -v: registers,
    shared memory and spills per kernel), written beside it."""
    return library_path() + ".ptxas.txt"


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu unless the library for these sources exists; return
    its path. The compiler's report (``-Xptxas=-v``) goes to
    ``build_report_path()``; verbose=True rebuilds and prints it."""
    out = library_path()
    if os.path.exists(out) and not verbose:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    objdir = tempfile.mkdtemp(dir=BUILD_DIR)
    nvcc = _nvcc()
    report = []

    def finish(cmd, proc):
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{stdout}\n{stderr}")
        report.append(stdout + stderr)

    try:
        # one compiler process per source, all started together
        jobs = []
        for src in sources():
            obj = os.path.join(objdir, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-c", src, "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.PIPE, text=True)))
        try:
            for cmd, _, proc in jobs:
                finish(cmd, proc)
        finally:
            for _, _, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        link = [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
        finish(link, subprocess.Popen(link, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
        if verbose:
            print("".join(report), flush=True)
        rep = tmp + ".ptxas.txt"
        with open(rep, "w") as f:
            f.write("".join(report))
        os.replace(rep, out + ".ptxas.txt")
        os.replace(tmp, out)  # atomic: a concurrent process never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
        shutil.rmtree(objdir, ignore_errors=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_char_p if name == "sfft_cuda_error_string" else ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = lib().sfft_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on t's device, as a pointer for a C entry."""
    return torch.cuda.current_stream(t.device).cuda_stream
