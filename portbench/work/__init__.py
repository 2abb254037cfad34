"""Work counts and the card's published peaks: the benchmark's yardstick.

Each count is a function of shapes and iteration counts alone, so it
reads the same whatever implements the work.  A kernel's count is the
least it must do: each input byte read once, each output byte written
once, and the operations the inputs need (``KernelWork``; the arithmetic
of the port's ``utils/profiling`` frozen here).  A request's flops are the
operations its mathematics needs (local solves, the refinement MLP, the
operator and preconditioner products of the iterations it took, the
vector updates), never what one implementation happens to spend, so a
share of the peak cannot pass 100% by a faster program.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CardPeaks:
    """Published dense peaks: HBM bandwidth (GB/s) and float32 outside the
    tensor cores (TFLOP/s)."""

    hbm_gb_s: float
    fp32_tflop_s: float


# NVIDIA data sheets, dense rates without sparsity, matched as substrings
# of ``torch.cuda.get_device_name()``, the more specific names first.
CARD_PEAKS = (
    ("H100 NVL", CardPeaks(3900.0, 60.0)),
    ("H100 PCIe", CardPeaks(2000.0, 51.0)),
    ("H100", CardPeaks(3350.0, 67.0)),  # SXM5: "NVIDIA H100 80GB HBM3"
)


def card_peaks(device_name: str) -> CardPeaks:
    for key, peaks in CARD_PEAKS:
        if key in device_name:
            return peaks
    raise ValueError(f"peaks of {device_name!r} are not known")


@dataclass(frozen=True)
class KernelWork:
    bytes: int
    flops: int

    def __add__(self, other: "KernelWork") -> "KernelWork":
        return KernelWork(self.bytes + other.bytes, self.flops + other.flops)

    def bound_s(self, peaks: CardPeaks) -> float:
        """The least time: the larger of bytes over the bandwidth and
        flops over the float32 peak."""
        return max(self.bytes / (peaks.hbm_gb_s * 1e9),
                   self.flops / (peaks.fp32_tflop_s * 1e12))


NO_WORK = KernelWork(0, 0)


def gauss_jordan_work(n: int, w: int, itemsize: int = 4) -> KernelWork:
    """Kernel B1 on n systems of width w: read S (w x w) and e (w), write
    y (w); unpivoted Gauss-Jordan on [S | e] updates, at step k, columns
    k + 1 .. w of the w - 1 other rows: (w - 1) w (w + 1) flops a
    system."""
    return KernelWork(bytes=itemsize * n * (w * w + 2 * w),
                      flops=(w - 1) * w * (w + 1) * n)


def dia_work(bands: int, n_pad: int) -> KernelWork:
    """Kernel B2 on ``bands`` bands of n_pad rows (float32): read the
    bands and x, write y; one multiply-add a band and row."""
    return KernelWork(bytes=4 * (bands + 2) * n_pad,
                      flops=2 * bands * n_pad)


def mlp_flops(columns: int, w: int, hidden: int) -> int:
    """The NeuralFSAI refinement MLP on ``columns`` columns: 4w -> hidden
    -> hidden -> two heads of w, a multiply-add a weight."""
    return 2 * columns * (4 * w * hidden + hidden * hidden + 2 * hidden * w)


def pcg_vector_flops(n: int) -> int:
    """One PCG iteration's dots and updates on n rows: three dots (rz,
    p.Ap, r.r) and three axpys (x, r, p), two flops an element each."""
    return 12 * n


def learned_apply_flops(nnz_c: int, nnz_a: int, degree: int) -> int:
    """z = C q(B) q(B)^T C^T r with B = C^T A C, applied in factored form:
    C^T and C once each, and 2 * degree products of B, each C, A and C^T
    (a multiply-add a stored entry)."""
    return 4 * nnz_c + 2 * degree * (4 * nnz_c + 2 * nnz_a)


def learned_case_flops(n0: int, nnz_a: int, nnz_c: int, width: int,
                       hidden: int, degree: int, iterations: int) -> int:
    """One sludge case's learned setup and solve: the local solves and the
    MLP of its n0 columns, and at the start and each iteration the
    operator product, the factored preconditioner apply and the vector
    updates."""
    per_iter = (2 * nnz_a + pcg_vector_flops(n0)
                + learned_apply_flops(nnz_c, nnz_a, degree))
    return (gauss_jordan_work(n0, width).flops + mlp_flops(n0, width, hidden)
            + (iterations + 1) * per_iter)
