"""Device selection, kernel build and load, and per-kernel launch counts.

The CUDA kernels live as sources under ``csrc/`` and are compiled with
``nvcc`` into one shared library with a plain C interface on first use
(``kernel_library``: one ``nvcc -c`` per source, all started together,
then one link), then bound with ``ctypes``.  Nothing is built or loaded
at import time: the CPU tests import every module of the port.

Every kernel wrapper calls ``count_launch(name)`` right after a launch the
kernel accepted, and nowhere else, so a run can show that its main path
went through the kernels (``reset_launch_counts`` / ``launch_counts``).
Every plain version calls ``count_plain(name, tensor)``, which counts the
calls made on a CUDA tensor (``plain_cuda_counts``): a main path on the
card must read 0 there, since on the card only a comparison with the
kernel runs the plain version.
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
KERNELS = ("gauss_jordan", "dia_spmv", "bsr_spmm")

_launches: dict[str, int] = dict.fromkeys(KERNELS, 0)
_plain_on_cuda: dict[str, int] = dict.fromkeys(KERNELS, 0)
_library: ctypes.CDLL | None = None
build_log: str = ""  # nvcc's output (ptxas register/spill report)
build_seconds: dict[str, float] = {}  # source name -> seconds of its nvcc


def device() -> torch.device:
    """The card the port's main path runs on: ``cuda:0``, or raise."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's main path runs on the GPU only"
        )
    return torch.device("cuda", 0)


def count_launch(name: str) -> None:
    _launches[name] += 1


def count_plain(name: str, tensor: torch.Tensor) -> None:
    """Record a call of ``name``'s plain version if it ran on the card."""
    if tensor.device.type == "cuda":
        _plain_on_cuda[name] += 1


def reset_launch_counts() -> None:
    """Zero the launch counts and the plain-on-CUDA counts."""
    for name in KERNELS:
        _launches[name] = 0
        _plain_on_cuda[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def plain_cuda_counts() -> dict[str, int]:
    return dict(_plain_on_cuda)


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
    lib.dp_gauss_jordan_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.dp_gauss_jordan_f32.restype = ctypes.c_int
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
    _library = lib
    return lib
