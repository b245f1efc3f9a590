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

Each wrapper declares the kernel entries it calls, once, as an
:class:`Entry` beside the code that passes the arguments: the C name, the
dtypes it is built for, its C argument types and the counters of
``utils/profiling.py`` a launch adds to.  :meth:`Entry.launch` is the one
way a kernel is launched: it picks the dtype's symbol, passes the current
stream last, turns the ``cudaGetLastError()`` every launch entry returns
into an exception (:func:`check`) and counts.  A new kernel is its ``.cu``
and its wrapper.  A failed build raises :class:`BuildError`, which no caller
catches: there is no fallback to the plain PyTorch versions for CUDA
tensors, nor to another host factorization.
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

import torch

from .utils import profiling

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

# C argument types of the kernel entries: a pointer (device data or a
# stream), an int, an int64_t, a double
P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
F64 = ctypes.c_double
# what a launch or layout entry returns: a cudaError_t (an int), checked
STATUS = "cudaError_t"
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}

# C name without the dtype suffix -> its Entry: every declared entry
ENTRIES: dict = {}

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


class Entry:
    """One entry of the kernel library, declared once by its wrapper.

    ``stem`` is the C name; an entry built for ``dtypes`` has one symbol a
    dtype, the stem with ``_f32`` or ``_f64``.  ``args`` are its C argument
    types; a ``launch`` entry takes the stream after them.  ``restype`` is
    what it returns: a ``STATUS`` is checked, anything else handed back.
    Each launch adds one to each of ``counters`` (``utils/profiling.py``);
    ``what`` names the entry in errors (the stem without ``cpkt_``)."""

    def __init__(self, stem: str, args: tuple, *, dtypes: tuple = (),
                 launch: bool = True, restype=STATUS, counters: tuple = (),
                 what: str | None = None):
        if stem in ENTRIES:
            raise ValueError(f"kernel entry {stem} declared twice")
        unknown = set(counters) - profiling.COUNTS.keys()
        if unknown:
            raise ValueError(f"{stem}: unknown counters {sorted(unknown)}")
        self.stem, self.dtypes, self.is_launch = stem, tuple(dtypes), launch
        self.argtypes = [*args, P] if launch else list(args)
        self.restype, self.counters = restype, tuple(counters)
        self.what = what or stem.removeprefix("cpkt_")
        self._fns: dict = {}
        ENTRIES[stem] = self

    def symbols(self) -> dict:
        """dtype (None for an entry without dtypes) -> C symbol."""
        return ({d: self.stem + _SUFFIX[d] for d in self.dtypes}
                or {None: self.stem})

    def _fn(self, dtype):
        """The symbol for ``dtype``, typed at its first call."""
        fn = self._fns.get(dtype)
        if fn is None:
            name = self.symbols().get(dtype if self.dtypes else None)
            if name is None:
                raise TypeError(f"{self.what}: unsupported dtype {dtype}")
            fn = getattr(kernel_library(), name)
            fn.argtypes = self.argtypes
            fn.restype = I32 if self.restype == STATUS else self.restype
            self._fns[dtype] = fn
        return fn

    def launch(self, like: torch.Tensor, *args, stream: int | None = None,
               counted: bool = True) -> None:
        """Launch for ``like``'s dtype on the current stream of its device
        (or ``stream``); raise on a CUDA error; count unless not
        ``counted`` (a measurement)."""
        fn = self._fns.get(like.dtype) or self._fn(like.dtype)
        if stream is None:
            stream = torch.cuda.current_stream(like.device).cuda_stream
        status = fn(*args, stream)
        if status:
            check(status, self.what)
        if counted:
            for key in self.counters:
                profiling.count(key)

    def __call__(self, *args, dtype=None):
        """Call a layout or query entry (no stream, never counted): its
        value, or None for a checked status."""
        out = self._fn(dtype)(*args)
        if self.restype != STATUS:
            return out
        check(out, self.what)
        return None
