"""Plain reference of the HPCG problem through the learned structured FSAI,
in float64 torch.

The problem is HPCG 3.1's (``GenerateProblem_ref.cpp``) on one rank's
box: a 27-point stencil, 26 on the diagonal and -1 for each neighbour
inside the box (neighbours outside it dropped), b = A 1 and x0 = 0.  The
operator is DIA: ``vals[d, i]`` multiplies ``x[i + offsets[d]]``, offsets
ascending.

The setup is ``reference/structured.py``'s for a given stencil
(``learned_setup``): the FSAI pattern is every sum of at most ``power``
steps of the operator's stencil whose linear offset is nonnegative, here
the 3^3 box (``box_slots``: at power 1, 14 slots); each column solves its
local system over its live slots, the refinement MLP reads
[c / max(|c_0|, 1e-20), a_col, pos1h, pad], a wrap of degree > 0 is
checked by 8 power steps of B = C~^T A~ C~ and 65 points of
[0, 1.15 lambda_max], and the factor comes out as bands[k, j] =
C[j + o_k, j] with C = D^-1/2 C~, with q.  ``structured.poly_apply`` is
the wrap's apply.  Columns go through in blocks, so the reference fits
beside a freed program at 256^3; TF32 is off while it runs.

Where this departs from HPCG: the program under test computes in float32
where HPCG computes in float64 (this reference is float64); its
preconditioner is the learned structured FSAI in place of HPCG's
symmetric Gauss-Seidel multigrid; and a solve runs to a tolerance in
place of HPCG's fixed sets of 50 iterations.
"""

from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch

from portbench.reference.neural_fsai import q_vector, refine, rounder
from portbench.reference.structured import (
    BLOCK,
    GRID,
    MARGIN,
    POWER_STEPS,
    Bands,
    lower,
    slot_live,
    upper,
)


def hpcg_bands(shape, device, n_pad: int | None = None):
    """(vals (27, n_pad) float64, offsets ascending) of HPCG's matrix on
    the box ``shape``: each band is the product of three one-axis masks of
    the neighbours inside the box."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    n_pad = n_pad or ((n + 1023) // 1024) * 1024
    strides = [int(np.prod(shape[i + 1:])) for i in range(3)]
    steps = sorted(itertools.product((-1, 0, 1), repeat=3),
                   key=lambda d: int(np.dot(d, strides)))
    vals = torch.zeros(len(steps), n_pad, dtype=torch.float64,
                       device=device)
    for k, d in enumerate(steps):
        masks = []
        for ax, step in enumerate(d):
            i = torch.arange(shape[ax], device=device) + step
            masks.append(((i >= 0) & (i < shape[ax])).double())
        box = (masks[0][:, None, None] * masks[1][None, :, None]
               * masks[2][None, None, :])
        vals[k, :n] = box.reshape(-1) * (26.0 if d == (0, 0, 0) else -1.0)
    return vals, tuple(int(np.dot(d, strides)) for d in steps)


def box_slots(shape, power: int):
    """(offsets ascending, per slot its displacement vectors): every sum of
    at most ``power`` box steps (each coordinate within ``power``) with a
    nonnegative linear offset."""
    ndim = len(shape)
    strides = np.array([int(np.prod(shape[i + 1:])) for i in range(ndim)])
    by_offset = {}
    for d in itertools.product(range(-power, power + 1), repeat=ndim):
        off = int(np.dot(d, strides))
        if off >= 0:
            by_offset.setdefault(off, []).append(d)
    offsets = sorted(by_offset)
    return offsets, [np.array(by_offset[o]) for o in offsets]


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matrix products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def learned_setup(vals: torch.Tensor, a_offsets, shape, slots,
                  weights: dict, device, precision: str | None = None):
    """(bands (w, n_pad), q) of the raw operator ``vals`` (float64) on the
    pattern ``slots`` (``box_slots`` or ``structured.stencil_slots``);
    ``precision="bf16"`` is the control (``neural_fsai.rounder``)."""
    rnd = rounder(precision)
    offsets, classes = slots
    w = len(offsets)
    if w != weights["width"]:
        raise ValueError(f"{w} slots, the model has {weights['width']}")
    with no_tf32():
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
        del a
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
            e = torch.zeros(rows.shape[0], w, dtype=torch.float64,
                            device=device)
            e[:, 0] = 1.0
            y = torch.linalg.solve(sub, e)
            del sub
            c = rnd(torch.where(lv, y / torch.sqrt(y[:, :1]), 0.0))
            a_col = torch.stack([a_s.entry(-o, rows + o) for o in offsets],
                                dim=-1)
            a_col = torch.where(lv & lv[:, :1], a_col, 0.0)
            out[:, lo:lo + rows.shape[0]] = refine(
                weights, c, a_col, pos1h.expand_as(c), (~lv).double(),
                rnd).T
        q = rnd(q_vector(weights, device))
        if q.shape[0] > 1:
            def b_(t):
                return upper(out, offsets, a_s.matvec(lower(out, offsets,
                                                            t)))

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
