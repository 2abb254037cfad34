"""The work counts against hand-worked values."""

from portbench.work import (
    CardPeaks,
    card_peaks,
    dia_work,
    gauss_jordan_work,
    mlp_flops,
)


def test_b1_w24_n1024():
    # read S (24 x 24) and e (24), write y (24): 624 floats a system;
    # (w - 1) w (w + 1) = 23 * 24 * 25 = 13 800 flops a system
    work = gauss_jordan_work(1024, 24)
    assert work.bytes == 4 * 1024 * 624 == 2_555_904
    assert work.flops == 13_800 * 1024 == 14_131_200


def test_b2_seven_bands_128_cubed():
    # read 7 bands and x, write y: 9 floats a row; 7 multiply-adds a row
    work = dia_work(7, 128 ** 3)
    assert work.bytes == 36 * 2_097_152 == 75_497_472
    assert work.flops == 14 * 2_097_152 == 29_360_128


def test_bounds_against_the_h100_peaks():
    peaks = card_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == CardPeaks(3350.0, 67.0)
    # B2 at 128^3 is bound by bytes: 75.5 MB at 3350 GB/s = 22.54 us
    assert abs(dia_work(7, 128 ** 3).bound_s(peaks) - 22.536559e-6) < 1e-11
    # B1 at w 24, N 1024: 2.56 MB at 3350 GB/s = 0.763 us
    assert abs(gauss_jordan_work(1024, 24).bound_s(peaks)
               - 0.762956e-6) < 1e-11


def test_mlp_flops_w24_hidden64():
    # 96 x 64 + 64 x 64 + 2 x 64 x 24 = 13 312 weights, 2 flops each
    assert mlp_flops(1, 24, 64) == 26_624
