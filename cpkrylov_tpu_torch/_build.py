"""Build and load the port's native code with plain C interfaces.

Two libraries, each built at first use and rebuilt whenever one of its
sources is newer than it, into ``build/cpkrylov_tpu_torch/`` beside the
package (a git-ignored directory):

* ``libcpkt_kernels.so``: the hand-written CUDA kernels (``csrc/*.cu``),
  compiled by ``nvcc`` for Hopper (``sm_90a``), one ``nvcc -c`` per source,
  all started together, then one link.  Nothing includes PyTorch's headers,
  so the build takes seconds; the kernels are called through ``ctypes`` with
  raw device pointers and the current stream.
* ``libcpkt_native.so``: the host LDL^T (``native/*.cpp``), compiled by
  ``g++``.

Every kernel entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a nonzero code into an exception.  A failed build raises
:class:`BuildError`, which no caller catches: there is no fallback to the
plain PyTorch versions for CUDA tensors, nor to another host factorization.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "cpkrylov_tpu_torch")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NATIVE_DIR = os.path.join(PKG_DIR, "native")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIBS: dict = {}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F64 = ctypes.c_double

# C signatures of the kernel library: (name, argtypes).  Every function
# returns an int (a cudaError_t) unless _RESTYPES says otherwise.
_KERNEL_SIGNATURES = {
    # data, offsets (int64, device), ndiag, nrows, ncols, x, y, stream
    "cpkt_dia_spmv_f32": (_P, _P, _I32, _I64, _I64, _P, _P, _P),
    "cpkt_dia_spmv_f64": (_P, _P, _I32, _I64, _I64, _P, _P, _P),
    # a, invd, b, x, state (the stream's self-resetting words), n,
    # reverse, stream
    "cpkt_bidiag_scan_f32": (_P, _P, _P, _P, _P, _I64, _I32, _P),
    "cpkt_bidiag_scan_f64": (_P, _P, _P, _P, _P, _I64, _I32, _P),
    # B2's loads and stores without its look-back: a, invd, b, x, n,
    # reverse, stream
    "cpkt_bidiag_read_floor_f32": (_P, _P, _P, _P, _I64, _I32, _P),
    "cpkt_bidiag_read_floor_f64": (_P, _P, _P, _P, _I64, _I32, _P),
    # scan positions per tile
    "cpkt_bidiag_tile": (),
    # hi, lo, offsets (int64, device), ndiag, nrows, ncols, xh, xl, yh, yl,
    # stream
    "cpkt_df_dia_spmv_f32": (_P, _P, _P, _I32, _I64, _I64, _P, _P, _P, _P,
                             _P),
    # B4's first phase: inv, b, c (nb*p), n, p, nb, stream
    "cpkt_band_c_f32": (_P, _P, _P, _I64, _I32, _I64, _P),
    "cpkt_band_c_f64": (_P, _P, _P, _I64, _I32, _I64, _P),
    # B6 (and its read floor): m (unit column stride) and its (row, step)
    # strides, alpha, c and its (row, step) strides, y and its (row, step)
    # strides, q, r, nb, stream
    "cpkt_affine_scan_f32": (_P, _I64, _I64, _F64, _P, _I64, _I64, _P, _I64,
                             _I64, _I32, _I32, _I64, _P),
    "cpkt_affine_scan_f64": (_P, _I64, _I64, _F64, _P, _I64, _I64, _P, _I64,
                             _I64, _I32, _I32, _I64, _P),
    "cpkt_scan_read_floor_f32": (_P, _I64, _I64, _F64, _P, _I64, _I64, _P,
                                 _I64, _I64, _I32, _I32, _I64, _P),
    "cpkt_scan_read_floor_f64": (_P, _I64, _I64, _F64, _P, _I64, _I64, _P,
                                 _I64, _I64, _I32, _I32, _I64, _P),
    # q, r, out (5 ints: cluster, rows a block, rows a warp, warps, bytes)
    "cpkt_scan_layout_f32": (_I32, _I32, _P),
    "cpkt_scan_layout_f64": (_I32, _I32, _P),
    # indptr (int64), indices (int32), data, tiles (int64: the first row of
    # each tile), ntiles, tile (entries a tile), nrows, nnz, x, y, stream
    "cpkt_csr_spmv_f32": (_P, _P, _P, _P, _I64, _I32, _I64, _I64, _P, _P,
                          _P),
    "cpkt_csr_spmv_f64": (_P, _P, _P, _P, _I64, _I32, _I64, _I64, _P, _P,
                          _P),
    # out (3 ints: threads a block, largest tile, halo)
    "cpkt_csr_spmv_layout": (_P,),
    # src, dst, n, m, c, itemsize (4 or 8), stream
    "cpkt_interleave": (_P, _P, _I64, _I64, _I64, _I32, _P),
    "cpkt_uninterleave": (_P, _P, _I64, _I64, _I64, _I32, _P),
    # B9: inv, off_data, off_cols, off_counts (int32), b, x (nb*p), scratch
    # (p, when rhs is not on chip), n, p, nb, K, on_chip, stream
    "cpkt_block_tri_f32": (_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I64,
                           _I32, _I32, _P),
    "cpkt_block_tri_f64": (_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I64,
                           _I32, _I32, _P),
    # the most shared memory a block may take on a device
    "cpkt_smem_optin": (_I32,),
    # B10: hi, lo, cols (int32), counts (int32), K, n, xh, xl, yh, yl,
    # stream
    "cpkt_df_tri_matvec_f32": (_P, _P, _P, _P, _I32, _I64, _P, _P, _P, _P,
                               _P),
}


# functions that return something else than a cudaError_t
_RESTYPES = {"cpkt_smem_optin": _I64, "cpkt_csr_spmv_layout": None}


class BuildError(Exception):
    """A native library could not be built.  Deliberately not a
    ``RuntimeError``, so that numeric fallbacks never swallow it."""


def _sources(directory: str, patterns) -> list:
    out = []
    for pat in patterns:
        out += glob.glob(os.path.join(directory, pat))
    return sorted(out)


def _stale(lib: str, deps: list) -> bool:
    if not os.path.exists(lib):
        return True
    t = os.path.getmtime(lib)
    return any(os.path.getmtime(s) > t for s in deps)


def _install(name: str, deps: list, make) -> str:
    """Build BUILD_DIR/name with ``make(tmp_path, tmp_dir)`` unless it is up
    to date.

    The library is written under a temporary name and renamed into place,
    so concurrent processes (test workers) never load a half-written file.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, name)
    if not _stale(lib, deps):
        return lib
    with tempfile.TemporaryDirectory(dir=BUILD_DIR,
                                     prefix=name + ".") as tmp_dir:
        tmp = os.path.join(tmp_dir, name)
        make(tmp, tmp_dir)
        os.replace(tmp, lib)
    return lib


def _run(cmd: list, what: str) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise BuildError(f"building {what} failed ({cmd[0]}):\n"
                         f"{proc.stdout}\n{proc.stderr}")


def _build(name: str, compiler: list, sources: list, deps: list) -> str:
    """Compile ``sources`` into BUILD_DIR/name with one compiler call unless
    it is up to date."""
    return _install(name, deps, lambda out, _: _run(
        [*compiler, "-o", out, *sources], name))


def _compile_cuda(out: str, tmp_dir: str, sources: list) -> None:
    """One ``nvcc -c`` per source, all started together, then one link."""
    nvcc = nvcc_path()
    procs = []
    for src in sources:
        obj = os.path.join(tmp_dir, os.path.basename(src) + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, _, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)}:\n{stdout}\n{stderr}")
    if failed:
        raise BuildError("building the CUDA kernels failed (nvcc):\n"
                         + "\n".join(failed))
    _run([nvcc, "-shared", "-o", out, *(obj for _, obj, _ in procs)],
         "the CUDA kernel library")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` as PyTorch resolves it,
    else ``nvcc`` on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found: the CUDA kernels cannot be built")
    return found


def kernel_library() -> ctypes.CDLL:
    """Build (if stale) and load the CUDA kernel library."""
    with _LOCK:
        lib = _LIBS.get("kernels")
        if lib is not None:
            return lib
        sources = _sources(CSRC_DIR, ("*.cu",))
        deps = _sources(CSRC_DIR, ("*.cu", "*.cuh"))
        path = _install("libcpkt_kernels.so", deps,
                        lambda out, tmp: _compile_cuda(out, tmp, sources))
        lib = ctypes.CDLL(path)
        for fn, argtypes in _KERNEL_SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = _RESTYPES.get(fn, ctypes.c_int)
        lib.cpkt_error_string.argtypes = [ctypes.c_int]
        lib.cpkt_error_string.restype = ctypes.c_char_p
        _LIBS["kernels"] = lib
        return lib


def native_library() -> ctypes.CDLL:
    """Build (if stale) and load the host LDL^T library."""
    with _LOCK:
        lib = _LIBS.get("native")
        if lib is not None:
            return lib
        sources = _sources(NATIVE_DIR, ("*.cpp",))
        deps = _sources(NATIVE_DIR, ("*.cpp", "*.h"))
        path = _build("libcpkt_native.so", ["g++", *GXX_FLAGS], sources, deps)
        lib = ctypes.CDLL(path)
        _LIBS["native"] = lib
        return lib


def build_kernels() -> float:
    """Build and load the kernel library now; returns the seconds taken."""
    t0 = time.perf_counter()
    kernel_library()
    return time.perf_counter() - t0


def check(status: int, what: str) -> None:
    """Raise when a kernel entry point reported a CUDA error."""
    if status != 0:
        msg = kernel_library().cpkt_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
