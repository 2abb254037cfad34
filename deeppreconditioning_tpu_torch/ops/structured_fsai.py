"""Structured-grid FSAI: the learned preconditioner at 64^3 - 256^3.

Counterpart of ``deeppreconditioning_tpu/ops/structured_fsai.py``.  On a
structured grid every column's FSAI pattern is the same set of linear
offsets (the tril of the stencil-graph power), so

  * the pattern is a static tuple of offsets (``StructuredFSAIPlan``),
    built from the operator's own stencil: the 2d+1-point star of the
    Poisson operators, or the 3^d box of a 27-point operator such as
    HPCG's (``data/poisson.hpcg_operator``), read from its band offsets;
  * the local systems A~[S_j, S_j] are read from the DIA bands at static
    shifts, and solved by kernel B1 (``ops/gauss_jordan.py``);
  * the factor C is stored in offset-band form bands[k, j] = C[j + o_k, j]
    and applied as two DIA matvecs (C^T with the positive offsets, C with
    the negated ones, ``bands_to_dia``), i.e. through kernel B2;
  * boundary pruning is a coordinate mask (``slot_valid``).

``structured_refine`` runs the NeuralFSAI refinement head (the layers of
``models/neural_fsai.NeuralFSAI``) on offset-band columns, and
``poly_safeguard`` clamps a learned polynomial wrap whose roots fall
inside B's spectrum back to q = I.

The setup also takes S operators of one grid at once (the structured
trainer's samples, the reference's ``jax.vmap``): a ``DIAMatrix`` whose
values are (S, n_diag, n_pad) gives bands (S, w, n_pad), with every
sample's local systems in one B1 launch per chunk of columns and the
refinement MLP over all S * n_pad columns.  ``offset_upper_matvec`` /
``offset_lower_matvec`` and ``make_structured_poly_apply`` are the
reference's offset-form apply (plain PyTorch, as it is plain XLA there),
the form the trainer differentiates; B1 sits before the parameters and
runs without a gradient, as in the reference.
"""

from __future__ import annotations

import functools
import itertools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.ops.gauss_jordan import masked_gauss_jordan
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix
from deeppreconditioning_tpu_torch.utils.graphs import capture_safe
from deeppreconditioning_tpu_torch.utils.tracing import span

CHUNK = 1 << 18  # columns per B1 launch: bounds the (T, w, w) systems
# poly_safeguard: power steps, the spectral margin and the test grid
SAFEGUARD_ITERS, SAFEGUARD_MARGIN, SAFEGUARD_GRID = 8, 1.15, 65


class StructuredFSAIPlan:
    """Static (host-built) pattern description, no device arrays.

    A slot is one unique nonnegative linear offset of the stencil-graph
    power; displacement vectors that alias one offset on a small grid
    form its class, live wherever any vector of the class stays inside
    the box.

    Attributes:
        shape: grid shape.
        offsets: (w,) unique linear offsets, ascending, offsets[0] = 0.
        disp_classes: per slot, the (m_k, ndim) displacement vectors.
        a_offsets: linear offsets of the operator's DIA bands.
        delta_idx: (w, w) int, delta_idx[p, q] = band d with
            A[j + o_p, j + o_q] = vals[d, j + o_p], or -1.
    """

    def __init__(self, shape, disp, a_offsets):
        self.shape = tuple(int(s) for s in shape)
        disp = np.asarray(disp, np.int64)
        lin = disp @ _strides(self.shape)
        offs = np.unique(lin[lin >= 0])
        if offs[0] != 0:
            raise ValueError("pattern must contain the diagonal")
        self.offsets = tuple(int(o) for o in offs)
        self.disp_classes = [disp[lin == o] for o in self.offsets]
        self.a_offsets = tuple(int(o) for o in a_offsets)
        if len(set(self.a_offsets)) != len(self.a_offsets):
            raise ValueError("operator offsets must be unique")
        w = len(self.offsets)
        self.delta_idx = np.full((w, w), -1, np.int64)
        for p in range(w):
            for q in range(w):
                delta = self.offsets[q] - self.offsets[p]
                if delta in self.a_offsets:
                    self.delta_idx[p, q] = self.a_offsets.index(delta)

    @property
    def width(self) -> int:
        return len(self.offsets)


def _strides(shape: Sequence[int]) -> np.ndarray:
    nd = len(shape)
    return np.array([int(np.prod(shape[i + 1:])) for i in range(nd)],
                    np.int64)


def stencil_displacements(ndim: int, a_offsets=None,
                          shape: Sequence[int] | None = None) -> np.ndarray:
    """Displacement vectors of the operator's stencil.  Without
    ``a_offsets``, the standard 2*ndim+1-point star; with them, each
    linear offset of the operator's bands on ``shape`` read back as the
    vector of {-1, 0, 1}^ndim with that offset and the fewest nonzero
    entries (a 7-point operator gives its star, a 27-point one its 3^3
    box).  Raises where an offset has no such vector or two of them."""
    if a_offsets is None:
        disp = [np.zeros(ndim, np.int64)]
        for ax in range(ndim):
            for sgn in (-1, 1):
                d = np.zeros(ndim, np.int64)
                d[ax] = sgn
                disp.append(d)
        return np.stack(disp)
    if shape is None or len(shape) != ndim:
        raise ValueError("reading a stencil from offsets needs the shape")
    steps = np.array(list(itertools.product((-1, 0, 1), repeat=ndim)),
                     np.int64)
    lin = steps @ _strides(shape)
    nonzero = np.count_nonzero(steps, axis=1)
    disp = []
    for off in sorted({int(o) for o in a_offsets}):
        hits = np.flatnonzero(lin == off)
        if hits.size == 0:
            raise ValueError(f"offset {off} is no stencil step on {shape}")
        least = hits[nonzero[hits] == nonzero[hits].min()]
        if least.size > 1:
            raise ValueError(f"offset {off} is {least.size} stencil steps "
                             f"on {shape}")
        disp.append(steps[least[0]])
    return np.stack(disp)


def build_structured_plan(shape: Sequence[int], power: int = 2,
                          a_offsets=None) -> StructuredFSAIPlan:
    """Pattern = tril of the stencil-graph ``power`` (every sum of at most
    ``power`` stencil steps with a nonnegative linear offset), where the
    stencil is the operator's (``stencil_displacements`` of its band
    offsets ``a_offsets``; the 2*ndim+1-point star without them); cached
    per (shape, power, stencil).  Records the host span
    ``structured.plan`` (``utils/tracing.py``)."""
    shape = tuple(int(s) for s in shape)
    with span("structured.plan"):
        steps = stencil_displacements(len(shape), a_offsets, shape)
        return _build_structured_plan_cached(
            shape, int(power), tuple(sorted(map(tuple, steps.tolist()))))


@functools.lru_cache(maxsize=None)
def _build_structured_plan_cached(shape: Tuple[int, ...], power: int,
                                  steps: tuple) -> StructuredFSAIPlan:
    ndim = len(shape)
    steps = np.array(steps, np.int64).reshape(-1, ndim)
    reach = {tuple(np.zeros(ndim, np.int64))}
    frontier = set(reach)
    for _ in range(power):
        nxt = set()
        for f in frontier:
            for s in steps:
                nxt.add(tuple(np.asarray(f) + s))
        frontier = nxt - reach
        reach |= nxt
    strides = _strides(shape)
    disp = np.array(sorted(reach), np.int64).reshape(-1, ndim)
    a_offsets = tuple(sorted(int(d @ strides) for d in steps))
    return StructuredFSAIPlan(shape, disp, a_offsets)


def dia_sorted_by_offset(a: DIAMatrix) -> DIAMatrix:
    """DIA with bands sorted by offset (the plan's a_offsets order)."""
    order = np.argsort(a.offsets, kind="stable")
    if list(order) == list(range(len(a.offsets))):
        return a
    return DIAMatrix(
        vals=a.vals[..., torch.as_tensor(order, device=a.vals.device), :],
        offsets=tuple(a.offsets[i] for i in order),
        n=a.n,
    )


def _coords(shape, n_pad: int, device) -> list[torch.Tensor]:
    """Per-linear-index grid coordinates (mixed-radix peel of an arange;
    unclamped beyond n)."""
    coords = []
    rem = torch.arange(n_pad, device=device)
    for s in _strides(shape):
        coords.append(rem // int(s))
        rem = rem - coords[-1] * int(s)
    return coords


def slot_valid(plan: StructuredFSAIPlan, n_pad: int, device=None,
               dtype=torch.float32) -> torch.Tensor:
    """(n_pad, w) 0/1 mask: slot k is live at column j iff any vector of
    its displacement class stays inside the box, and j < n."""
    shape = plan.shape
    n = int(np.prod(shape))
    coords = _coords(shape, n_pad, device)
    live = torch.arange(n_pad, device=device) < n
    masks = []
    for k in range(plan.width):
        any_ok = torch.zeros(n_pad, dtype=torch.bool, device=device)
        for d_vec in plan.disp_classes[k]:
            ok = live
            for ax in range(len(shape)):
                c = coords[ax] + int(d_vec[ax])
                ok = ok & (c >= 0) & (c < shape[ax])
            any_ok = any_ok | ok
        masks.append(any_ok)
    return torch.stack(masks, dim=1).to(dtype)


def _band_reads(a_scaled: DIAMatrix, plan: StructuredFSAIPlan):
    """The bands zero-extended past n_pad, with one extra zero band for
    the slot pairs the operator does not couple, as (S, bands * length)
    rows (S = 1 unbatched): a read of band d at row i of sample s is
    ``flat[s, d * length + i]``; (flat, length, zero band)."""
    halo = max(plan.offsets[-1], a_scaled.halo)
    vals = F.pad(a_scaled.vals, (0, 2 * halo))
    vals = torch.cat([vals, torch.zeros_like(vals[..., :1, :])], dim=-2)
    bands, length = vals.shape[-2:]
    return vals.reshape(-1, bands * length), length, bands - 1


def _local_systems(reads, plan: StructuredFSAIPlan, valid: torch.Tensor,
                   lo: int, count: int):
    """The local systems of columns lo..lo+count-1 of every sample from
    ``_band_reads``: ``sub`` (S * T, w, w), sample-major, with
    sub[t, p, q] = A~[j + o_p, j + o_q] on live slot pairs and the
    identity on dead slots, and the unit right-hand side ``e`` (S * T, w)
    at slot 0.  One gather for the whole chunk."""
    flat, length, zero_band = reads
    w = plan.width
    dev = flat.device
    band = np.where(plan.delta_idx < 0, zero_band, plan.delta_idx)
    base = band * length + np.asarray(plan.offsets)[:, None]  # (w, w)
    rows = torch.arange(lo, lo + count, device=dev)
    idx = torch.as_tensor(base, device=dev)[None] + rows[:, None, None]
    vt = valid[lo:lo + count]  # (T, w)
    sub = flat[:, idx] * vt[:, :, None] * vt[:, None, :]  # (S, T, w, w)
    eye = torch.eye(w, dtype=sub.dtype, device=dev)
    sub = (sub + eye * (1.0 - vt)[:, None, :]).reshape(-1, w, w)
    e = torch.zeros((sub.shape[0], w), dtype=sub.dtype, device=dev)
    e[:, 0] = 1.0
    return sub, e


def structured_fsai_columns(a_scaled: DIAMatrix, plan: StructuredFSAIPlan,
                            chunk: int = CHUNK) -> torch.Tensor:
    """FSAI column values on the scaled operator, offset-band layout.

    Returns bands (w, n_pad), or (S, w, n_pad) for S operators:
    bands[..., k, j] = C~[j + offsets[k], j], from the normal-equations
    local solve with a unit target at slot 0 (one B1 launch per chunk of
    columns, every sample's in it) and the 1/sqrt(y_0) normalisation.
    """
    n_pad = a_scaled.n_pad
    dtype = a_scaled.vals.dtype
    valid = slot_valid(plan, n_pad, a_scaled.vals.device, dtype)
    if n_pad % chunk != 0:
        chunk = n_pad
    reads = _band_reads(a_scaled, plan)
    samples = reads[0].shape[0]
    outs = []
    for lo in range(0, n_pad, chunk):
        sub, e = _local_systems(reads, plan, valid, lo, chunk)
        y = masked_gauss_jordan(sub, e)  # (S * T, w)
        del sub, e
        c = y * torch.rsqrt(torch.clamp(y[:, 0], min=1e-30))[:, None]
        outs.append(c.reshape(samples, chunk, -1) * valid[lo:lo + chunk])
    bands = torch.cat(outs, dim=1).transpose(1, 2).contiguous()
    return bands.reshape(a_scaled.vals.shape[:-2] + bands.shape[1:])


def structured_a_col(a_scaled: DIAMatrix,
                     plan: StructuredFSAIPlan) -> torch.Tensor:
    """a_col[..., j, k] = A~[j + o_k, j] masked: the refinement MLP's
    local structure feature, (n_pad, w) or (S, n_pad, w)."""
    n_pad = a_scaled.n_pad
    valid = slot_valid(plan, n_pad, a_scaled.vals.device,
                       a_scaled.vals.dtype)
    flat, length, zero_band = _band_reads(a_scaled, plan)
    cols = []
    for k, off in enumerate(plan.offsets):
        d = int(plan.delta_idx[k, 0])  # A[j + o_k, j]
        start = (zero_band if d < 0 else d) * length + off
        cols.append(flat[:, start:start + n_pad] * valid[:, k] * valid[:, 0])
    a_col = torch.stack(cols, dim=-1)
    return a_col.reshape(a_scaled.vals.shape[:-2] + a_col.shape[1:])


def structured_refine(model, c_bands: torch.Tensor, a_col: torch.Tensor,
                      valid: torch.Tensor):
    """NeuralFSAI refinement head on offset-band columns.

    Uses ``model``'s dense0 / dense1 / alpha / beta layers (tanh GELU) on
    the features ``[c / max(|c_0|, 1e-20), a_col, pos1h, pad]`` with
    ``pos1h`` the one-hot of slot 0 and ``pad = 1 - valid``; the refined
    column is ``(c * exp(alpha) + (1 - pos1h) * beta * c_0) * valid`` and
    q = e0 + q_coeffs.  The whole (..., n_pad, 4w) feature block goes
    through at once (features and activations ~1 GB at 128^3, w = 13,
    float32), every sample's columns in one pass; the gradient flows from
    the refined bands and q into the layers.
    Returns (refined bands (..., w, n_pad), q_coeffs).
    """
    c = c_bands.transpose(-1, -2)  # (..., n_pad, w)
    pad = 1.0 - valid
    pos1h = torch.zeros_like(valid[0])
    pos1h[0] = 1.0
    c_diag = c[..., 0:1]
    denom = torch.clamp(c_diag.abs(), min=1e-20)
    feats = torch.cat([c / denom, a_col.expand_as(c), pos1h.expand_as(c),
                       pad.expand_as(c)], dim=-1)
    h = model.act(model.dense0(feats))
    h = model.act(model.dense1(h))
    alpha = model.alpha(h)
    beta = model.beta(h)
    refined = (c * torch.exp(alpha) + (1.0 - pos1h) * beta * c_diag) * valid
    dq = model.q_coeffs
    q0 = torch.zeros_like(dq)
    q0[0] = 1.0
    return refined.transpose(-1, -2).contiguous(), q0 + dq


def fold_scaling(bands: torch.Tensor, d_isqrt: torch.Tensor,
                 offsets: Tuple[int, ...]) -> torch.Tensor:
    """C_eff = D^-1/2 C~ in offset-band layout:
    bands_eff[..., k, j] = d_isqrt[..., j + o_k] * bands[..., k, j]."""
    n_pad = bands.shape[-1]
    d_ext = F.pad(d_isqrt, (0, max(offsets)))
    return torch.stack([
        bands[..., k, :] * d_ext[..., off:off + n_pad]
        for k, off in enumerate(offsets)
    ], dim=-2)


def offset_upper_matvec(bands: torch.Tensor, r: torch.Tensor,
                        offsets: Tuple[int, ...]) -> torch.Tensor:
    """t = C^T r: t[j] = sum_k bands[k, j] r[j + o_k], accumulated in
    slot order (a leading batch axis on both is kept)."""
    n_pad = r.shape[-1]
    r_ext = F.pad(r, (0, max(offsets)))
    t = torch.zeros_like(r)
    for k, off in enumerate(offsets):
        t = t + bands[..., k, :] * r_ext[..., off:off + n_pad]
    return t


def offset_lower_matvec(bands: torch.Tensor, t: torch.Tensor,
                        offsets: Tuple[int, ...]) -> torch.Tensor:
    """z = C t: z[i] = sum_k bands[k, i - o_k] t[i - o_k], each band's
    product padded into place and the terms summed in slot order (a
    leading batch axis on both is kept)."""
    n_pad = t.shape[-1]
    z = None
    for k, off in enumerate(offsets):
        term = F.pad(bands[..., k, :n_pad - off] * t[..., :n_pad - off],
                     (off, 0))
        z = term if z is None else z + term
    return z


def bands_to_dia(bands: torch.Tensor, offsets: Tuple[int, ...],
                 n: int) -> Tuple[DIAMatrix, DIAMatrix]:
    """Offset-band factor -> (C^T, C) as DIA operators.

    C^T r is a DIA matvec with the positive offsets on the bands as they
    are; C t re-bases each band once (rb[k, i] = bands[k, i - o_k]) and is
    a DIA matvec with the negated offsets.
    """
    n_pad = bands.shape[-1]
    rows = [bands[..., k, :] if off == 0
            else F.pad(bands[..., k, :n_pad - off], (off, 0))
            for k, off in enumerate(offsets)]
    c_up = DIAMatrix(vals=bands.contiguous(), offsets=tuple(offsets), n=n)
    c_low = DIAMatrix(vals=torch.stack(rows, dim=-2),
                      offsets=tuple(-o for o in offsets), n=n)
    return c_up, c_low


def make_structured_poly_apply_dia(degree: int):
    """z = C q(B) q(B)^T C^T r with B = C^T A C, every factor half and
    operator matvec one DIA matvec (kernel B2 on the card);
    m_data = (c_up, c_low, q_coeffs, a_raw).  The apply is declared
    ``capture_safe``: the single-system solver replays it from a CUDA
    graph; it declares the 2 * degree products with A a call makes
    (``operator_products``), which the solvers count."""

    @capture_safe
    def apply_fn(m_data, r: torch.Tensor) -> torch.Tensor:
        c_up, c_low, q_coeffs, a_raw = m_data

        def b_(t):
            return dia_matvec(c_up, dia_matvec(a_raw, dia_matvec(c_low, t)))

        def q_(t):
            u = q_coeffs[degree] * t
            for i in range(degree - 1, -1, -1):
                u = b_(u) + q_coeffs[i] * t
            return u

        return dia_matvec(c_low, q_(q_(dia_matvec(c_up, r))))

    apply_fn.operator_products = 2 * degree
    return apply_fn


def make_structured_poly_apply(offsets: Tuple[int, ...], degree: int):
    """z = C q(B) q(B)^T C^T r in offset form, B = C^T A C: the factor
    halves are ``offset_upper_matvec`` / ``offset_lower_matvec`` on the
    bands, the operator product is ``dia_matvec`` (kernel B2 on the card,
    with its backward where r needs a gradient); m_data = (bands_eff,
    q_coeffs, a_raw) or (bands_eff, q_coeffs, a_raw, a_raw^T) with A^T for
    that backward.  Bands and r may carry a leading batch axis."""

    def apply_fn(m_data, r: torch.Tensor) -> torch.Tensor:
        bands, q_coeffs, a_raw, *a_t = m_data
        a_t = a_t[0] if a_t else None

        def b_(t):
            return offset_upper_matvec(
                bands, dia_matvec(a_raw, offset_lower_matvec(
                    bands, t, offsets), a_t), offsets)

        def q_(t):
            u = q_coeffs[degree] * t
            for i in range(degree - 1, -1, -1):
                u = b_(u) + q_coeffs[i] * t
            return u

        return offset_lower_matvec(
            bands, q_(q_(offset_upper_matvec(bands, r, offsets))), offsets)

    return apply_fn


def poly_safeguard(bands: torch.Tensor, q_coeffs: torch.Tensor,
                   a_scaled: DIAMatrix, offsets: Tuple[int, ...]):
    """Clamp an unsafe polynomial wrap back to q = I at setup time.

    8 normalised power steps of B = C~^T A~ C~ from the fixed start
    ``sin(0.7 i) + 0.5`` estimate lambda_max; q is evaluated (Horner) on
    65 points of [0, 1.15 * lambda_max], and any nonpositive value
    selects q = I.  No host read: the flag stays on the device.
    Returns (q_safe, safe_flag, lambda_max).
    """
    n_pad = bands.shape[1]
    dtype = bands.dtype
    dev = bands.device
    c_up, c_low = bands_to_dia(bands, offsets, a_scaled.n)

    def b_(t):
        return dia_matvec(c_up, dia_matvec(a_scaled, dia_matvec(c_low, t)))

    v = torch.sin(torch.arange(n_pad, dtype=dtype, device=dev) * 0.7) + 0.5
    for _ in range(SAFEGUARD_ITERS):
        w = b_(v)
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    w = b_(v)
    lam_max = torch.dot(v, w) / torch.clamp(torch.dot(v, v), min=1e-30)
    ts = torch.linspace(0.0, SAFEGUARD_MARGIN, SAFEGUARD_GRID, dtype=dtype,
                        device=dev) * lam_max
    deg = q_coeffs.shape[0] - 1
    qv = torch.ones_like(ts) * q_coeffs[deg]
    for i in range(deg - 1, -1, -1):
        qv = qv * ts + q_coeffs[i]
    safe = qv.min() > 0.0
    ident = torch.zeros_like(q_coeffs)
    ident[0] = 1.0
    return torch.where(safe, q_coeffs, ident), safe, lam_max


def jacobi_scale_dia(a: DIAMatrix) -> Tuple[DIAMatrix, torch.Tensor]:
    """(A~, d_sqrt): symmetric Jacobi scaling in DIA form,
    A~[i, i+off] = A[i, i+off] / (d_sqrt[i] d_sqrt[i+off])."""
    d = a.vals[..., a.offsets.index(0), :]
    d_safe = torch.where(d == 0, torch.ones_like(d), d)
    d_isqrt = torch.where(d == 0, torch.zeros_like(d),
                          1.0 / torch.sqrt(d_safe))
    n_pad, halo = a.n_pad, a.halo
    d_ext = F.pad(d_isqrt, (halo, halo))
    rows = [a.vals[..., k, :] * d_isqrt
            * d_ext[..., halo + off:halo + off + n_pad]
            for k, off in enumerate(a.offsets)]
    return (DIAMatrix(vals=torch.stack(rows, dim=-2), offsets=a.offsets,
                      n=a.n),
            torch.sqrt(d_safe) * (d != 0))


def structured_setup(a_raw: DIAMatrix, plan: StructuredFSAIPlan, model=None,
                     safeguard: bool = True):
    """Deployed setup: scale -> local solves -> (learned refinement +
    spectral safeguard) -> scaling fold.  Returns (bands_eff (w, n_pad),
    q_coeffs) for ``bands_to_dia`` and ``make_structured_poly_apply_dia``
    with the RAW operator.  ``model=None`` gives classical FSAI (q = 1);
    a degree-0 model skips the safeguard (q has one coefficient), and so
    does ``safeguard=False`` (the trainer's: the clamp would freeze q).
    Batched values (S, n_diag, n_pad) give bands (S, w, n_pad) and one q;
    they take no safeguard, which clamps per operator.  Under a
    ``torch.profiler`` it records the span ``structured.setup`` with the
    children ``structured.columns`` (sort, scale, local solves),
    ``structured.refine`` and ``structured.safeguard``
    (``utils/tracing.py``)."""
    dev = a_raw.vals.device
    with span("structured.setup", dev):
        with span("structured.columns", dev):
            a_sorted = dia_sorted_by_offset(a_raw)
            a_scaled, d_sqrt = jacobi_scale_dia(a_sorted)
            # the parameters enter after the local solves: without a
            # gradient for the operator they run under no_grad (B1 has no
            # backward)
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and a_scaled.vals.requires_grad):
                c_bands = structured_fsai_columns(a_scaled, plan)
        if model is None:
            q = torch.ones(1, dtype=c_bands.dtype, device=c_bands.device)
        else:
            with span("structured.refine", dev):
                valid = slot_valid(plan, a_sorted.n_pad, c_bands.device,
                                   c_bands.dtype)
                a_col = structured_a_col(a_scaled, plan)
                c_bands, q = structured_refine(model, c_bands, a_col, valid)
            if safeguard and q.shape[0] > 1:
                if c_bands.dim() != 2:
                    raise ValueError("the safeguard clamps one operator's q: "
                                     "batched setups take safeguard=False")
                with span("structured.safeguard", dev):
                    q, _, _ = poly_safeguard(c_bands, q, a_scaled,
                                             plan.offsets)
        d_isqrt = torch.where(d_sqrt == 0, torch.zeros_like(d_sqrt),
                              1.0 / d_sqrt)
        return fold_scaling(c_bands, d_isqrt, plan.offsets), q
