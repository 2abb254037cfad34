"""The kernels' minimum bytes, flops and bounds (``utils/profiling``)
against values worked out by hand at the shapes the paths run: B1 at the
per-case, frames and scaling widths, B2 on the 128^3 and 256^3 Poisson
operators and the 13-band factor halves, B3 on the frame operator's 7002
non-sentinel blocks at m = 1, 8 and 128.  The card's numbers are the H100
SXM data sheet's (3350 GB/s HBM, 67 TFLOP/s float32, 495 TFLOP/s TF32)."""

import pytest

from deeppreconditioning_tpu_torch.utils.profiling import (
    CardPeaks,
    KernelWork,
    bsr_work,
    card_peaks,
    dia_work,
    fp64_tflop_s,
    gauss_jordan_work,
    hbm_bandwidth_gb_s,
)

CARD = "NVIDIA H100 80GB HBM3"
FRAME_BLOCKS, FRAME_N_PAD = 7002, 802 * 128  # of 802 x 9 = 7218 slots


def _bound(work, tensor_cores=False):
    peaks = card_peaks(CARD)
    return work.bound(peaks.hbm_gb_s, peaks.tf32x3_tflop_s
                      if tensor_cores else peaks.fp32_tflop_s)


@pytest.mark.parametrize("n, w, nbytes, flops", [
    # 4 N (w^2 + 2w) bytes, (w - 1) w (w + 1) N flops: every shape is
    # bound by its bytes
    (1024, 24, 4 * 1024 * 624, 23 * 24 * 25 * 1024),
    (768, 41, 4 * 768 * 1763, 40 * 41 * 42 * 768),
    (262144, 13, 204472320, 572522496),
    (262144, 4, 25165824, 15728640),
    (131072, 24, 327155712, 1808793600),
    (131072, 41, 924319744, 9028239360),
    (131072, 63, 2146959360, 32765902848),
])
def test_gauss_jordan_work(n, w, nbytes, flops):
    work = gauss_jordan_work(n, w)
    assert (work.bytes, work.flops) == (nbytes, flops)
    assert _bound(work) == (pytest.approx(nbytes / 3350e9), "bytes")


def test_gauss_jordan_bounds_in_microseconds():
    """B1's bounds at the aims' shapes: 98 us at w 24, 276 us at w 41,
    641 us at w 63 (whose flops take 489 us at the float32 peak), 61 us
    at the scaling launch."""
    us = {key: _bound(gauss_jordan_work(*key))[0] * 1e6
          for key in ((131072, 24), (131072, 41), (131072, 63),
                      (262144, 13))}
    assert us[(131072, 24)] == pytest.approx(97.658, abs=1e-3)
    assert us[(131072, 41)] == pytest.approx(275.916, abs=1e-3)
    assert us[(131072, 63)] == pytest.approx(640.883, abs=1e-3)
    assert gauss_jordan_work(131072, 63).flops / 67e12 * 1e6 == (
        pytest.approx(489.043, abs=1e-3))
    assert us[(262144, 13)] == pytest.approx(61.037, abs=1e-3)


@pytest.mark.parametrize("n, w, nbytes, us", [
    # float64: 8 N (w^2 + 2w) bytes against 3350 GB/s; the flops against
    # 34 TFLOP/s (DFMA outside the tensor cores) stay below them
    (896, 24, 8 * 896 * 624, 1.3352),  # residual parity's learned row
    (131072, 24, 654311424, 195.317),
    (131072, 41, 1848639488, 551.833),
])
def test_gauss_jordan_work_f64(n, w, nbytes, us):
    work = gauss_jordan_work(n, w, itemsize=8)
    assert (work.bytes, work.flops) == (nbytes,
                                        (w - 1) * w * (w + 1) * n)
    rate = fp64_tflop_s(CARD)
    assert rate == 34.0
    bound, roof = work.bound(card_peaks(CARD).hbm_gb_s, rate)
    assert roof == "bytes" and bound * 1e6 == pytest.approx(us, abs=1e-3)
    assert work.flops / (rate * 1e12) < bound
    assert fp64_tflop_s("NVIDIA H100 PCIe") == 26.0


@pytest.mark.parametrize("bands, n_pad, nbytes, flops", [
    (7, 128 ** 3, 9 * 4 * 128 ** 3, 14 * 128 ** 3),       # 75.5 MB
    (7, 256 ** 3, 9 * 4 * 256 ** 3, 14 * 256 ** 3),       # 604 MB
    (13, 128 ** 3, 15 * 4 * 128 ** 3, 26 * 128 ** 3),     # factor halves
])
def test_dia_work(bands, n_pad, nbytes, flops):
    work = dia_work(bands, n_pad)
    assert (work.bytes, work.flops) == (nbytes, flops)
    assert _bound(work) == (pytest.approx(nbytes / 3350e9), "bytes")


@pytest.mark.parametrize("m, nbytes, flops, roof, tc_roof", [
    (1, 459704320, 229441536, "bytes", "bytes"),
    (8, 465453056, 1835532288, "bytes", "bytes"),
    (128, 564002816, 29368516608, "operations", "operations"),
])
def test_bsr_work(m, nbytes, flops, roof, tc_roof):
    work = bsr_work(FRAME_BLOCKS, FRAME_N_PAD, 128, m)
    assert work.bytes == 4 * (7002 * 128 * 128 + 2 * 102656 * m)
    assert (work.bytes, work.flops) == (nbytes, flops)
    assert _bound(work)[1] == roof
    assert _bound(work, tensor_cores=True)[1] == tc_roof


def test_bsr_bounds_in_microseconds():
    """m = 8: 139 us of bytes; m = 128: 438 us at the float32 roof, 178 us
    at the 3xTF32 roof (165 TFLOP/s), above its 168 us of bytes."""
    m8 = bsr_work(FRAME_BLOCKS, FRAME_N_PAD, 128, 8)
    m128 = bsr_work(FRAME_BLOCKS, FRAME_N_PAD, 128, 128)
    assert _bound(m8)[0] * 1e6 == pytest.approx(138.941, abs=1e-3)
    assert _bound(m128)[0] * 1e6 == pytest.approx(438.336, abs=1e-3)
    assert _bound(m128, tensor_cores=True)[0] * 1e6 == pytest.approx(
        177.991, abs=1e-3)
    assert m128.bytes / 3350e9 * 1e6 == pytest.approx(168.359, abs=1e-3)


def test_bound_picks_the_larger_roof():
    assert KernelWork(bytes=3350, flops=0).bound(3350.0, 67.0) == (
        pytest.approx(1e-9), "bytes")
    assert KernelWork(bytes=0, flops=67000).bound(3350.0, 67.0) == (
        pytest.approx(1e-9), "operations")


@pytest.mark.parametrize("name, peaks, tf32x3", [
    ("NVIDIA H100 80GB HBM3", CardPeaks(3350.0, 67.0, 495.0), 165.0),
    ("NVIDIA H100 PCIe", CardPeaks(2000.0, 51.0, 378.0), 126.0),
    ("NVIDIA H100 NVL", CardPeaks(3900.0, 60.0, 417.5), 417.5 / 3),
])
def test_card_peaks_by_name(name, peaks, tf32x3):
    assert card_peaks(name) == peaks
    assert card_peaks(name).tf32x3_tflop_s == pytest.approx(tf32x3)
    assert hbm_bandwidth_gb_s(name) == peaks.hbm_gb_s
    with pytest.raises(ValueError, match="not known"):
        card_peaks("NVIDIA A100-SXM4-80GB")
