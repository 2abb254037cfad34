"""Banded factor-form preconditioner apply, batch-first.

Counterpart of ``deeppreconditioning_tpu/ops/banded_factor.py``, plain
PyTorch (the reference computes these in XLA, with no Pallas kernel).  A
lower-triangular factor C whose pattern spread ``max(row - col) + 1`` is
D fits the diagonal-major band layout

    bands[d, j] = C[j + d, j],   d in [0, D), j in [0, n_pad)

and both halves of the factor apply are shift-multiply-reduce over
strided views, one pass each however large D is:

* C^T r: t[j] = sum_d bands[d, j] r[j + d] reads the zero-padded r
  through ``unfold`` (window j is r[j : j + D]);
* C t: z[i] = sum_d bands[d, i - d] t[i - d] reads u = bands * t through
  the pad-flatten skew: row d of u padded to n + D and viewed with row
  stride n + D - 1 is u shifted right by d.

A bf16 band array multiplies as float32 against the float32 vector, so
the products are those of the bf16-rounded bands, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def band_spread(out_rows: np.ndarray, n_pad: int) -> int:
    """Max ``row - col + 1`` of an FSAI column pattern (host): ``out_rows``
    is the (..., n_pad, w) plan row-set array, sentinel n_pad."""
    out_rows = np.asarray(out_rows)
    n = out_rows.shape[-2]
    cols = np.arange(n, dtype=out_rows.dtype)[:, None]
    offs = np.where(out_rows < n_pad, out_rows - cols, 0)
    return int(offs.max(initial=0)) + 1


def extract_bands(
    out_rows: torch.Tensor,  # (..., n_pad, w), sentinel n_pad
    c_vals: torch.Tensor,  # (..., n_pad, w) column values of C
    d_max: int,
    d_isqrt: Optional[torch.Tensor] = None,
    n0=None,
) -> torch.Tensor:
    """Column values -> bands (..., d_max, n_pad), by index placement.

    Folds the Jacobi scaling (C_eff = D^-1/2 C~, rows scaled) and masks
    rows and columns >= n0 (per case for a group).  Offsets >= d_max are
    dropped, as the reference's one-hot contraction drops them: take
    ``d_max`` from ``band_spread`` of the same patterns."""
    n_pad = c_vals.shape[-2]
    lead = c_vals.shape[:-2]
    cols = torch.arange(n_pad, device=c_vals.device)[:, None]
    safe_rows = out_rows.clamp(max=n_pad - 1)
    offs = out_rows - cols
    live = (out_rows < n_pad) & (offs < d_max)
    vals = c_vals
    if d_isqrt is not None:
        vals = vals * d_isqrt.to(vals.dtype).gather(
            -1, safe_rows.flatten(-2)).reshape(safe_rows.shape)
    if n0 is not None:
        if torch.is_tensor(n0) and n0.dim() == 1:
            n0 = n0.reshape(-1, 1, 1)
        live = live & (safe_rows < n0) & (cols < n0)
    vals = torch.where(live, vals, 0.0)
    slot = torch.where(live, offs * n_pad + cols, d_max * n_pad)
    bands = vals.new_zeros(*lead, d_max * n_pad + 1)
    bands.scatter_add_(-1, slot.flatten(-2), vals.flatten(-2))
    return bands[..., :-1].reshape(*lead, d_max, n_pad)


def banded_upper_matvec(bands: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """t = C^T r: t[j] = sum_d bands[d, j] r[j + d]; bands (..., D, n),
    r (..., n)."""
    n = r.shape[-1]
    d_n = bands.shape[-2]
    win = torch.nn.functional.pad(r, (0, d_n)).unfold(-1, d_n, 1)[..., :n, :]
    return (bands.transpose(-1, -2) * win).sum(dim=-1)


def banded_lower_matvec(bands: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """z = C t: z[i] = sum_d bands[d, i - d] t[i - d]; bands (..., D, n),
    t (..., n)."""
    n = t.shape[-1]
    d_n = bands.shape[-2]
    u = torch.nn.functional.pad(bands * t[..., None, :], (0, d_n))
    skew = u.as_strided(
        (*u.shape[:-2], d_n, n),
        (*u.stride()[:-2], n + d_n - 1, 1),
        u.storage_offset(),
    )
    return skew.sum(dim=-2)


def make_banded_poly_apply(matvec, degree: int):
    """The batched polynomial FSAI apply in band form,

        z = C q(B) q(B)^T C^T r,   B = C^T A C,

    as ``apply(m_data, r)`` with m_data = (bands (B, D, n), q_coeffs
    (B, degree + 1), a_data) and ``matvec(a_data, x)`` the batched raw
    matvec.  q = [1, 0, ...] gives z = C (C^T r)."""

    def apply_fn(m_data, r: torch.Tensor) -> torch.Tensor:
        bands, q_coeffs, a_data = m_data
        dtype = r.dtype

        def c_t(x):
            return banded_upper_matvec(bands, x).to(dtype)

        def c_(t):
            return banded_lower_matvec(bands, t).to(dtype)

        def b_(t):
            return c_t(matvec(a_data, c_(t)))

        def q_(t):  # Horner
            u = q_coeffs[..., degree:degree + 1].to(dtype) * t
            for i in range(degree - 1, -1, -1):
                u = b_(u) + q_coeffs[..., i:i + 1].to(dtype) * t
            return u

        return c_(q_(q_(c_t(r))))

    return apply_fn
