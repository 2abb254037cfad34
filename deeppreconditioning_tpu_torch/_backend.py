"""Device selection, kernel build and load, and per-kernel launch counts.

The CUDA kernels live as sources under ``csrc/`` and are compiled with
``nvcc`` into one shared library with a plain C interface on first use
(``kernel_library``: one ``nvcc -c`` per source, all started together,
then one link), then bound with ``ctypes``.  Nothing is built or loaded
at import time: the CPU tests import every module of the port.

Every kernel wrapper calls ``count_launch(name)`` right after a launch the
kernel accepted, and nowhere else, so a run can show that its main path
went through the kernels (``reset_launch_counts`` / ``launch_counts``).
A wrapper with more than one instance passes the launch's dtype too, and
``dtype_launch_counts`` keeps those launches by (name, dtype).
Every plain version calls ``count_plain(name, tensor)``, which counts the
calls made on a CUDA tensor (``plain_cuda_counts``): a main path on the
card must read 0 there, since on the card only a comparison with the
kernel runs the plain version.  A CUDA graph's capture launches nothing,
so the counts its wrappers made then are taken back out
(``launch_state`` / ``launches_since``) and added again on every replay
(``add_launches``), both by ``utils/graphs.py``: the counts stay the
launches that ran.

The host runtime (``csrc/host_runtime.cpp``: IC(0), ICT, trisolve levels,
conv plans, FVM assembly) is C++ for the host, built with ``g++`` into
``build/torch_host/`` on first use (``host_library``) and bound by
``native/__init__.py``.  Each native call is counted per entry point
(``count_host_call``), and so is each call that took an entry point's
numpy version instead (``count_host_fallback``): a path on the card must
read 0 fallbacks.  ``reset_launch_counts`` zeroes these counts too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

# The JAX reference runs its dense products at Precision.HIGHEST; keep
# float32 products in full float32 on the card (no TF32 rounding).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("gauss_jordan", "dia_spmv", "bsr_spmm", "gram_assembly",
           "pcg_iteration")
HOST_SOURCE = CSRC / "host_runtime.cpp"
HOST_BUILD_DIR = BUILD_DIR.parent / "torch_host"
# -ffp-contract=off: no fused multiply-add, so a factor rounds as numpy's
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")
HOST_ENTRIES = ("conv_plan", "ic0", "ict", "levels", "fvm_assemble")

_launches: dict[str, int] = dict.fromkeys(KERNELS, 0)
_dtype_launches: dict[tuple[str, str], int] = {}
_plain_on_cuda: dict[str, int] = dict.fromkeys(KERNELS, 0)
_host_calls: dict[str, int] = dict.fromkeys(HOST_ENTRIES, 0)
_host_fallbacks: dict[str, int] = dict.fromkeys(HOST_ENTRIES, 0)
_library: ctypes.CDLL | None = None
_host: ctypes.CDLL | None = None
build_log: str = ""  # nvcc's output (ptxas register/spill report)
build_seconds: dict[str, float] = {}  # source name -> seconds of its nvcc
host_build_seconds: float = 0.0  # g++'s seconds (0 if the build was cached)


def device() -> torch.device:
    """The card the port's main path runs on: ``cuda:0``, or raise."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's main path runs on the GPU only"
        )
    return torch.device("cuda", 0)


def count_launch(name: str, dtype: torch.dtype | None = None) -> None:
    _launches[name] += 1
    if dtype is not None:
        key = (name, str(dtype).removeprefix("torch."))
        _dtype_launches[key] = _dtype_launches.get(key, 0) + 1


def count_plain(name: str, tensor: torch.Tensor) -> None:
    """Record a call of ``name``'s plain version if it ran on the card."""
    if tensor.device.type == "cuda":
        _plain_on_cuda[name] += 1


def count_host_call(name: str) -> None:
    _host_calls[name] += 1


def count_host_fallback(name: str) -> None:
    """Record a call that ran entry point ``name``'s numpy version."""
    _host_fallbacks[name] += 1


def reset_launch_counts() -> None:
    """Zero the launch counts, the plain-on-CUDA counts and the host
    runtime's call and fallback counts."""
    for name in KERNELS:
        _launches[name] = 0
        _plain_on_cuda[name] = 0
    _dtype_launches.clear()
    for name in HOST_ENTRIES:
        _host_calls[name] = 0
        _host_fallbacks[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def _replayed_counts() -> tuple:
    return _launches, _dtype_launches, _plain_on_cuda


def launch_state() -> tuple:
    """Copies of the counts a CUDA graph replays (launches, launches by
    dtype, plain calls on CUDA), for ``launches_since``."""
    return tuple(dict(counts) for counts in _replayed_counts())


def launches_since(state: tuple) -> tuple:
    """What was counted since ``state`` (``launch_state()``), taken back
    out of the counts: a CUDA graph's capture counts launches that run
    only when the graph is replayed, and each replay adds them
    (``add_launches``)."""
    delta = []
    for counts, before in zip(_replayed_counts(), state):
        delta.append({key: n - before.get(key, 0)
                      for key, n in counts.items()
                      if n != before.get(key, 0)})
        counts.clear()
        counts.update(before)
    return tuple(delta)


def add_launches(delta: tuple) -> None:
    """Count a replay of a captured graph: ``delta`` is its capture's
    ``launches_since``."""
    for counts, added in zip(_replayed_counts(), delta):
        for key, n in added.items():
            counts[key] = counts.get(key, 0) + n


def dtype_launch_counts() -> dict[tuple[str, str], int]:
    """Launches by (kernel, dtype), e.g. ("gauss_jordan", "float64")."""
    return dict(_dtype_launches)


def plain_cuda_counts() -> dict[str, int]:
    return dict(_plain_on_cuda)


def host_call_counts() -> dict[str, int]:
    return dict(_host_calls)


def host_fallback_counts() -> dict[str, int]:
    return dict(_host_fallbacks)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: cannot build the CUDA kernels")


def _build(sources: list[Path], lib_path: Path) -> str:
    """Compile every source to an object in parallel, link the library
    atomically into ``lib_path``; return nvcc's combined output."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    outputs = [obj.with_suffix(".log") for obj in objects]
    t0 = time.perf_counter()
    procs = []
    for src, obj, out in zip(sources, objects, outputs):
        with out.open("w") as fio:
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=fio, stderr=subprocess.STDOUT,
            ))
    pending = dict(zip(sources, procs))
    while pending:
        for src, proc in list(pending.items()):
            if proc.poll() is not None:
                build_seconds[src.name] = time.perf_counter() - t0
                del pending[src]
        time.sleep(0.05)
    logs, failed = [], False
    for src, proc, out in zip(sources, procs, outputs):
        logs.append(f"--- {src.name}\n{out.read_text()}")
        out.unlink()
        failed |= proc.returncode != 0
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{log}")
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *map(str, objects)],
        capture_output=True, text=True,
    )
    for obj in objects:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    return log


def kernel_library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library.

    The library is named by a hash of the sources and flags, so an edited
    kernel is rebuilt and a stale build is never loaded.  Raises if nvcc
    is missing or the build or load fails; there is no fallback.
    """
    global _library, build_log
    if _library is not None:
        return _library
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libdp_kernels_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        build_log = _build(sources, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for entry in (lib.dp_gauss_jordan_f32, lib.dp_gauss_jordan_f64):
        entry.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        entry.restype = ctypes.c_int
    # vals, x, y, the launch plan's parameter block, the stream.  B2 runs
    # once per product and the call only enqueues a launch, so it keeps
    # the GIL (no release and re-acquire around it).
    lib.dp_dia_spmv_f32 = ctypes.PYFUNCTYPE(
        ctypes.c_int, *[ctypes.c_void_p] * 5)(("dp_dia_spmv_f32", lib))
    lib.dp_bsr_spmm_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.dp_bsr_spmm_f32.restype = ctypes.c_int
    # g, lo, m, B, H, n_pad, the stream
    for entry in (lib.dp_gram_assembly_f32, lib.dp_gram_assembly_f64):
        entry.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        entry.restype = ctypes.c_int
    # the PCG iteration's two halves (ops/pcg_iteration.py): vectors,
    # scalars, n, grid, max_iter (and rtol), the stream; per iteration,
    # so they keep the GIL as B2 does
    vec = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
    for dt in ("f32", "f64"):
        setattr(lib, f"dp_pcg_xr_{dt}", ctypes.PYFUNCTYPE(
            ctypes.c_int, *vec, ctypes.c_double, ctypes.c_void_p)(
                (f"dp_pcg_xr_{dt}", lib)))
        setattr(lib, f"dp_pcg_p_{dt}", ctypes.PYFUNCTYPE(
            ctypes.c_int, *vec[1:], ctypes.c_void_p)((f"dp_pcg_p_{dt}", lib)))
    _library = lib
    return lib


def host_compiler() -> str | None:
    """The C++ compiler of the host runtime (``$CXX``, else ``g++``), or
    None if there is none."""
    return shutil.which(os.environ.get("CXX", "g++"))


def host_library() -> ctypes.CDLL:
    """Build (once per source content and flags) and load the host runtime.

    ``g++`` compiles ``csrc/host_runtime.cpp`` to a temporary name that
    is renamed into place, so processes that build at once never load a
    half-written library.  Raises with the compiler's output if the build
    fails, and if there is no compiler.
    """
    global _host, host_build_seconds
    if _host is not None:
        return _host
    cxx = host_compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX): cannot build the "
                           "host runtime")
    digest = hashlib.sha256(HOST_SOURCE.read_bytes())
    digest.update(" ".join(HOST_FLAGS).encode())
    lib_path = HOST_BUILD_DIR / f"libdp_host_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        out = subprocess.run(
            [cxx, *HOST_FLAGS, "-o", str(tmp), str(HOST_SOURCE)],
            capture_output=True, text=True,
        )
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{cxx} failed to build the host runtime:\n"
                f"{out.stdout}{out.stderr}")
        os.replace(tmp, lib_path)
        host_build_seconds = time.perf_counter() - t0
    _host = ctypes.CDLL(str(lib_path))
    return _host
