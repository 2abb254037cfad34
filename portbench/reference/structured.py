"""Plain reference of the structured-grid learned setup, in float64 torch.

On a grid every column's FSAI pattern is the same set of displacements:
every sum of at most ``power`` steps of the 2d+1-point stencil whose
linear offset is nonnegative.  Displacements with one linear offset form
a slot, live at column j where any of them stays inside the grid.  Column
j solves A~[j + o_p, j + o_q] y = e_0 over its live slots (the identity
on the others) and takes c = y / sqrt(y_0); the refinement MLP of
``reference/neural_fsai.refine`` reads [c / max(|c_0|, 1e-20), a_col,
pos1h, pad] with a_col[k] = A~[j + o_k, j].  A wrap of degree > 0 is
checked once: 8 normalised power steps of B = C~^T A~ C~ from sin(0.7 i)
+ 0.5 estimate lambda_max, q is evaluated on 65 points of [0, 1.15
lambda_max], and a nonpositive value sets q = e0.  The result is the
factor in offset-band form, bands[k, j] = C[j + o_k, j] with C = D^-1/2
C~, and q.

Operators are DIA: ``vals[d, i]`` multiplies ``x[i + offsets[d]]``.
Columns go through in blocks, so the reference fits beside the program's
state.  ``precision="bf16"`` is the control (``neural_fsai.rounder``).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from portbench.reference.neural_fsai import q_vector, refine, rounder

BLOCK = 1 << 18  # columns a block
POWER_STEPS, MARGIN, GRID = 8, 1.15, 65


def stencil_slots(shape, power: int):
    """(offsets ascending, per slot its displacement vectors)."""
    ndim = len(shape)
    strides = np.array([int(np.prod(shape[i + 1:])) for i in range(ndim)])
    disp = [d for d in itertools.product(range(-power, power + 1),
                                         repeat=ndim)
            if sum(abs(x) for x in d) <= power]
    by_offset = {}
    for d in disp:
        off = int(np.dot(d, strides))
        if off >= 0:
            by_offset.setdefault(off, []).append(d)
    offsets = sorted(by_offset)
    return offsets, [np.array(by_offset[o]) for o in offsets]


def slot_live(shape, classes, n_pad: int, device) -> torch.Tensor:
    """(n_pad, w) bool."""
    n = int(np.prod(shape))
    idx = torch.arange(n_pad, device=device)
    coords, rem = [], idx
    for ax in range(len(shape)):
        stride = int(np.prod(shape[ax + 1:]))
        coords.append(rem // stride)
        rem = rem - coords[-1] * stride
    cols = []
    for vecs in classes:
        ok_any = torch.zeros(n_pad, dtype=torch.bool, device=device)
        for d in vecs:
            ok = idx < n
            for ax, s in enumerate(shape):
                c = coords[ax] + int(d[ax])
                ok = ok & (c >= 0) & (c < s)
            ok_any = ok_any | ok
        cols.append(ok_any)
    return torch.stack(cols, dim=1)


class Bands:
    """A DIA operator in float64 with zero-extended reads."""

    def __init__(self, vals: torch.Tensor, offsets):
        self.vals = vals
        self.offsets = tuple(int(o) for o in offsets)
        self.n_pad = vals.shape[1]
        self.halo = max(abs(o) for o in self.offsets)
        self._ext = torch.nn.functional.pad(vals, (self.halo, self.halo))

    def entry(self, delta: int, rows: torch.Tensor) -> torch.Tensor:
        """A[i, i + delta] at rows i (0 off the bands or the matrix)."""
        if delta not in self.offsets:
            return torch.zeros(rows.shape, dtype=self.vals.dtype,
                               device=self.vals.device)
        d = self.offsets.index(delta)
        return self._ext[d, rows.clamp(-self.halo, self.n_pad + self.halo - 1)
                         + self.halo]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        xe = torch.nn.functional.pad(x, (self.halo, self.halo))
        y = torch.zeros_like(x)
        for d, off in enumerate(self.offsets):
            y = y + self.vals[d] * xe[self.halo + off:self.halo + off
                                      + self.n_pad]
        return y


def upper(bands, offsets, r):
    """t = C^T r: t[j] = sum_k bands[k, j] r[j + o_k]."""
    n_pad = r.shape[0]
    re = torch.nn.functional.pad(r, (0, max(offsets)))
    return sum(bands[k] * re[o:o + n_pad] for k, o in enumerate(offsets))


def lower(bands, offsets, t):
    """z = C t: z[i] = sum_k bands[k, i - o_k] t[i - o_k]."""
    n_pad = t.shape[0]
    z = torch.zeros_like(t)
    for k, o in enumerate(offsets):
        z[o:] += bands[k, :n_pad - o] * t[:n_pad - o]
    return z


def structured_learned(vals: torch.Tensor, a_offsets, shape,
                       weights: dict, device,
                       precision: str | None = None):
    """(bands (w, n_pad), q) of the raw operator ``vals`` (float64)."""
    rnd = rounder(precision)
    offsets, classes = stencil_slots(shape, weights["power"])
    w = len(offsets)
    if w != weights["width"]:
        raise ValueError(f"{w} slots, the model has {weights['width']}")
    a = Bands(torch.as_tensor(vals, dtype=torch.float64, device=device),
              a_offsets)
    n_pad = a.n_pad
    diag = a.vals[a.offsets.index(0)]
    d_isqrt = torch.where(diag > 0, 1.0 / torch.sqrt(
        torch.where(diag > 0, diag, 1.0)), 0.0)
    dpad = torch.nn.functional.pad(d_isqrt, (a.halo, a.halo))
    a_s = Bands(rnd(torch.stack([
        a.vals[d] * d_isqrt * dpad[a.halo + o:a.halo + o + n_pad]
        for d, o in enumerate(a.offsets)])), a.offsets)
    live = slot_live(shape, classes, n_pad, device)
    eye = torch.eye(w, dtype=torch.float64, device=device)
    pos1h = eye[0].expand(1, w)
    out = torch.zeros(w, n_pad, dtype=torch.float64, device=device)
    for lo in range(0, n_pad, BLOCK):
        rows = torch.arange(lo, min(lo + BLOCK, n_pad), device=device)
        lv = live[rows]
        sub = torch.stack([torch.stack([
            a_s.entry(offsets[q] - offsets[p], rows + offsets[p])
            for q in range(w)], dim=-1) for p in range(w)], dim=-2)
        pair = lv[:, :, None] & lv[:, None, :]
        sub = torch.where(pair, sub, 0.0) + eye * (~lv)[:, None, :]
        e = torch.zeros(rows.shape[0], w, dtype=torch.float64, device=device)
        e[:, 0] = 1.0
        y = torch.linalg.solve(sub, e)
        del sub
        c = rnd(torch.where(lv, y / torch.sqrt(y[:, :1]), 0.0))
        a_col = torch.stack([a_s.entry(-o, rows + o) for o in offsets],
                            dim=-1)
        a_col = torch.where(lv & lv[:, :1], a_col, 0.0)
        out[:, lo:lo + rows.shape[0]] = refine(
            weights, c, a_col, pos1h.expand_as(c), (~lv).double(), rnd).T
    q = rnd(q_vector(weights, device))
    if q.shape[0] > 1:
        def b_(t):
            return upper(out, offsets, a_s.matvec(lower(out, offsets, t)))

        v = torch.sin(torch.arange(n_pad, dtype=torch.float64,
                                   device=device) * 0.7) + 0.5
        for _ in range(POWER_STEPS):
            u = b_(v)
            v = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-30)
        u = b_(v)
        lam = torch.dot(v, u) / torch.clamp(torch.dot(v, v), min=1e-30)
        ts = torch.linspace(0.0, MARGIN, GRID, dtype=torch.float64,
                            device=device) * lam
        qv = torch.ones_like(ts) * q[-1]
        for coef in q.flip(0)[1:]:
            qv = qv * ts + coef
        if not bool(qv.min() > 0.0):
            q = torch.zeros_like(q)
            q[0] = 1.0
    dext = torch.nn.functional.pad(d_isqrt, (0, max(offsets)))
    bands = torch.stack([out[k] * dext[o:o + n_pad]
                         for k, o in enumerate(offsets)])
    return rnd(bands), q


def poly_apply(bands, offsets, q, matvec, r: torch.Tensor) -> torch.Tensor:
    """z = C q(B) q(B)^T C^T r with B = C^T A C (``matvec`` the raw A),
    q by Horner."""
    def b_(t):
        return upper(bands, offsets, matvec(lower(bands, offsets, t)))

    def q_(t):
        u = q[-1] * t
        for coef in q.flip(0)[1:]:
            u = b_(u) + coef * t
        return u

    return lower(bands, offsets, q_(q_(upper(bands, offsets, r))))


def dia_matvec64(vals: torch.Tensor, offsets,
                 x: torch.Tensor) -> torch.Tensor:
    a = Bands(torch.as_tensor(vals, dtype=torch.float64, device=x.device),
              offsets)
    return a.matvec(x.double())
