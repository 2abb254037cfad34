"""The SpMV roofline's operator builders and byte counts
(``bench/roofline.py``) at tiny sizes, against the JAX package's
``BSRMatrix.from_scipy`` on the reference's own constructions; the
timing itself needs the card."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu_torch.bench import roofline
from deeppreconditioning_tpu_torch.ops.bsr_spmm import bsr_matvec
from deeppreconditioning_tpu_torch.sparse.dia import poisson_dia


def _jax_bsr(mat, block_size):
    import jax.numpy as jnp

    from deeppreconditioning_tpu.sparse.bsr import BSRMatrix as JaxBSR

    return JaxBSR.from_scipy(mat, block_size=block_size, dtype=jnp.float32)


def _same(got, ref):
    np.testing.assert_array_equal(got.block_cols.numpy(),
                                  np.asarray(ref.block_cols))
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(ref.blocks))


def test_block_dense_operator_matches_the_reference_round_trip():
    n_rows, per_row, bs = 8, 5, 16
    got, nnz = roofline.block_dense_operator(n_rows, per_row, bs)
    # the reference's construction (spmv_roofline.py) at this size
    rng = np.random.default_rng(5)
    cols = rng.integers(0, n_rows, size=n_rows * per_row)
    blocks = rng.standard_normal((n_rows * per_row, bs, bs)).astype(
        np.float32)
    a_sp = sp.bsr_matrix(
        (blocks, cols, np.arange(0, n_rows * per_row + 1, per_row)),
        shape=(n_rows * bs, n_rows * bs),
    ).tocsr()
    _same(got, _jax_bsr(a_sp, bs))
    a_sp.sum_duplicates()
    assert nnz == a_sp.nnz
    assert got.n == got.n_pad == n_rows * bs


def test_frame_operator_matches_jax():
    from deeppreconditioning_tpu.data.frames import generate_frame_case

    dims = (3, 4, 3)
    got, nnz = roofline.frame_operator(dims, block_size=32)
    mat = generate_frame_case(np.random.default_rng(9), dims=dims,
                              solve=False).matrix.tocsr()
    _same(got, _jax_bsr(mat, 32))
    assert nnz == mat.nnz and got.n == mat.shape[0] == 6 * 3 * 4 * 2


def test_stencil_operator_matches_jax():
    from deeppreconditioning_tpu.data.fvm import generate_sludge_case_3d

    got, nnz = roofline.stencil_operator(10, block_size=16)
    mat = generate_sludge_case_3d(np.random.default_rng(7), dims=(10,) * 3,
                                  max_cells=1000, solve=False).matrix.tocsr()
    _same(got, _jax_bsr(mat, 16))
    assert nnz == mat.nnz
    x = np.random.default_rng(0).standard_normal(got.n_pad)
    x[got.n:] = 0.0
    y = bsr_matvec(got, torch.tensor(x, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(y[:got.n], mat @ x[:got.n], rtol=1e-5,
                               atol=1e-5 * np.abs(mat @ x[:got.n]).max())


@pytest.mark.parametrize("n_rows, slots, bs", [(3, 2, 16), (5, 4, 128)])
def test_bsr_bytes_count_every_stored_block(n_rows, slots, bs):
    from deeppreconditioning_tpu_torch.sparse.bsr import BSRMatrix

    a = BSRMatrix(blocks=torch.zeros((n_rows, slots, bs, bs)),
                  block_cols=torch.zeros((n_rows, slots), dtype=torch.int32),
                  n=n_rows * bs)
    assert roofline.bsr_bytes(a) == (n_rows * slots * bs * bs * 4
                                     + n_rows * slots * 4
                                     + 2 * n_rows * bs * 4)


@pytest.mark.parametrize("side", [8, 16])
def test_dia_bytes_and_nnz(side):
    a = poisson_dia((side,) * 3)
    assert len(a.offsets) == 7
    assert roofline.dia_bytes(7, a.n_pad) == 9 * a.n_pad * 4
    assert int(torch.count_nonzero(a.vals)) == (
        7 * side ** 3 - 6 * side ** 2)  # each face drops one link per cell
