"""Shared kernel utilities: ``cdiv``, ``measure_wall``, ``row_matmul`` and
the CUDA build.

Every hand-written kernel of this package is one ``.cu`` file beside its
``ops.py`` with a plain C interface.  :class:`CudaLibrary` compiles it with
``nvcc`` for ``sm_90a`` into a shared library under ``<repo>/build/kernels``
(or the directory :func:`set_build_dir` names) at first use, keyed by a
hash of the source, the local headers it includes and the flags, and loads
it with :mod:`ctypes`.  Nothing is built or loaded when a module is imported:
the CPU tests import every module, and the CPU has no ``nvcc``.  A kernel
that cannot be built, loaded or launched raises :class:`CudaKernelError`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

#: where built libraries land (listed in .gitignore); see set_build_dir.
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: environment override of the build directory (see set_build_dir).
BUILD_DIR_ENV = "REPRO_TORCH_KERNEL_DIR"


def set_build_dir(path=None) -> Path:
    """Point the kernel builds at ``path`` (made if missing) and return it:
    an explicit ``path``, else the ``REPRO_TORCH_KERNEL_DIR`` environment
    variable, else the checkout's ``build/kernels``.  A library already
    built there is loaded, not rebuilt (the file name is the hash of its
    sources and flags), so a persistent directory saves a restarted
    process its ``nvcc`` runs.  Libraries already loaded stay loaded."""
    global BUILD_DIR
    chosen = path or os.environ.get(BUILD_DIR_ENV)
    BUILD_DIR = (
        Path(chosen).expanduser() if chosen
        else Path(__file__).resolve().parents[3] / "build" / "kernels"
    )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR

#: the ``dtype`` argument of every kernel's C entry point (x, w and out).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


_LOCAL_INCLUDE = re.compile(r'\s*#\s*include\s+"([^"]+)"')


class CudaKernelError(RuntimeError):
    """A hand-written CUDA kernel failed to build (``nvcc`` missing or
    refusing the source), to load, or to launch.  It is a fault of the
    program, not of a request: callers let it propagate (the serving
    engine's degradation ladder re-raises it rather than serve the eager
    tier in the kernel's place)."""


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


#: rows per product tile of :func:`row_matmul`.
ROW_TILE = 128


def row_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` computed over fixed tiles of ``ROW_TILE`` rows, the last
    one zero-padded, so that each row's result does not depend on how many
    rows the call has.

    A plain ``torch.matmul`` lets the library pick its blocking (and, on
    the card, its split of the reduction) from the row count, so a row of a
    2,708-row product may differ in its last bits from the same row of a
    96-row product.  Every tile here is one ``(ROW_TILE, F) @ (F, G)``
    call, the same shape whatever the caller's row count, and a row's sum
    order does not depend on its place in the tile: partitioned and
    monolithic forwards then agree bit for bit, as the reference promises.
    It is one library call a tile, so it is host-bound on the card: the
    eager tier uses it; the kernel tier's products run the
    ``gemm_dataflow`` kernel, one launch.
    """
    tile = ROW_TILE
    dt = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    n = x.shape[0]
    out = torch.empty((n, w.shape[1]), dtype=dt, device=x.device)
    whole = n - n % tile
    for s in range(0, whole, tile):
        torch.mm(x[s:s + tile], w, out=out[s:s + tile])
    if whole < n:
        pad = torch.zeros((tile, x.shape[1]), dtype=dt, device=x.device)
        pad[: n - whole] = x[whole:]
        out[whole:] = torch.mm(pad, w)[: n - whole]
    return out


def measure_wall(
    fn,
    *,
    warmup: int = 1,
    iters: int = 5,
    reduce: str = "median",
) -> float:
    """Wall-clock seconds of one ``fn()`` call, measured properly.

    - every call is followed by ``torch.cuda.synchronize()`` when a CUDA
      device is present (launches are asynchronous: without it the clock
      times the enqueue, not the kernel);
    - the first ``warmup`` calls are discarded (kernel builds and allocator
      warmup land there);
    - the remaining ``iters`` timings are reduced by ``median`` (robust
      to scheduler noise; default), ``min`` or ``mean``.
    """
    if reduce not in ("median", "min", "mean"):
        raise ValueError(
            f"reduce must be 'median', 'min' or 'mean', got {reduce!r}"
        )
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    for _ in range(max(0, warmup)):
        fn()
        sync()
    ts = []
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    agg = {"median": np.median, "min": np.min, "mean": np.mean}[reduce]
    return float(agg(ts))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise CudaKernelError("nvcc not found: the CUDA kernels cannot be built")


class CudaLibrary:
    """One ``.cu`` source built into one shared library with a C interface.

    ``functions`` maps each exported C function to its ``argtypes``; every
    exported function returns an ``int`` (a ``cudaError_t``).  Each library
    also exports ``const char* <prefix>_error_string(int)`` so a wrapper can
    name a failed launch.
    """

    def __init__(self, source: Path, functions: dict[str, list]):
        self.source = Path(source)
        self.functions = functions
        self._lib: ctypes.CDLL | None = None

    @property
    def name(self) -> str:
        return self.source.stem

    def sources(self) -> list[Path]:
        """The ``.cu`` and every local header it includes (``#include
        "..."``, followed recursively), in a fixed order."""
        seen, todo = [], [self.source.resolve()]
        while todo:
            path = todo.pop(0)
            if path in seen:
                continue
            seen.append(path)
            for line in path.read_text().splitlines():
                m = _LOCAL_INCLUDE.match(line)
                if m:
                    todo.append((path.parent / m.group(1)).resolve())
        return seen

    def so_path(self) -> Path:
        h = hashlib.sha256()
        for path in self.sources():
            h.update(path.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def log_path(self) -> Path:
        return self.so_path().with_suffix(".log")

    def start_build(self) -> subprocess.Popen | None:
        """Start ``nvcc`` in the background (None when already built)."""
        so = self.so_path()
        if so.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.tmp.{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        proc.tmp_path = tmp  # type: ignore[attr-defined]
        return proc

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        tmp = proc.tmp_path  # type: ignore[attr-defined]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise CudaKernelError(
                f"nvcc failed on {self.source.name} (exit {proc.returncode}):\n"
                f"{out}"
            )
        self.log_path().write_text(out)
        os.replace(tmp, self.so_path())

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if it is missing."""
        if self._lib is None:
            self.finish_build(self.start_build())
            try:
                lib = ctypes.CDLL(str(self.so_path()))
                for fn, argtypes in self.functions.items():
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                err = getattr(lib, f"{self.name}_error_string")
            except (OSError, AttributeError) as e:
                raise CudaKernelError(f"cannot load {self.so_path().name}: {e}") from e
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, code: int, what: str) -> None:
        """Raise when a launch returned a CUDA error."""
        if code != 0:
            msg = getattr(self.load(), f"{self.name}_error_string")(code).decode()
            raise CudaKernelError(f"{what} failed: CUDA error {code} ({msg})")


def build_libraries(libs) -> float:
    """Build every library that is missing, all ``nvcc`` processes started
    together (one for each distinct build); returns the seconds taken."""
    t0 = time.perf_counter()
    procs, started = [], set()
    for lib in libs:  # two libraries of the same sources build once
        so = lib.so_path()
        procs.append((lib, None if so in started else lib.start_build()))
        started.add(so)
    for lib, proc in procs:
        lib.finish_build(proc)
    return time.perf_counter() - t0


def check_operands(name, indices, weights, x, w=None) -> None:
    """The operand contract both ELL kernels share (raises on anything
    else): ``indices`` int32 (V_pad, D), ``weights`` float32 (V_pad, D),
    ``x`` float32 or bfloat16 (V, F), ``w`` of x's dtype (F, G); all 2-D,
    contiguous and on one device."""
    if indices.dtype != torch.int32:
        raise TypeError(f"{name}: indices must be int32, got {indices.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"{name}: weights must be float32, got {weights.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if indices.dim() != 2 or weights.shape != indices.shape:
        raise ValueError(
            f"{name}: indices and weights must be one (V_pad, D) shape, got "
            f"{tuple(indices.shape)} and {tuple(weights.shape)}"
        )
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (V, F), got {tuple(x.shape)}")
    tensors = [indices, weights, x]
    if w is not None:
        if w.dtype != x.dtype:
            raise TypeError(f"{name}: w must be {x.dtype}, got {w.dtype}")
        if w.dim() != 2 or w.shape[0] != x.shape[1]:
            raise ValueError(
                f"{name}: w must be (F={x.shape[1]}, G), got {tuple(w.shape)}"
            )
        tensors.append(w)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"{name}: operands on several devices: "
            f"{[str(t.device) for t in tensors]}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if x.shape[0] == 0 and indices.numel() > 0:
        raise ValueError(f"{name}: x has no rows to gather from")
