"""BSR (block-sparse row) format: dense blocks on a fixed slot grid.

Counterpart of ``deeppreconditioning_tpu/sparse/bsr.py``.  The nonzeros
are grouped into dense (bs x bs) blocks, ELL-style: ``blocks`` is
(R, S, bs, bs), and ``block_cols`` (R, S) holds each slot's block-column
id, with the sentinel R marking an empty slot (its block is zero and it
reads a zero x block).  ``matvec`` / ``matmat`` are the plain PyTorch
version of kernel B3 (``ops/bsr_spmm.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu_torch import _backend


@dataclass
class BSRMatrix:
    """Square block-sparse matrix with a fixed number of block slots per
    block row.

    blocks: (R, S, bs, bs) dense blocks (zero on empty slots).
    block_cols: (R, S) int32 block-column ids; the sentinel R marks an
        empty slot.
    n: true dimension (R * bs >= n; rows and columns past n are zero).
    """

    blocks: torch.Tensor
    block_cols: torch.Tensor
    n: int

    @property
    def block_size(self) -> int:
        return self.blocks.shape[2]

    @property
    def n_block_rows(self) -> int:
        return self.blocks.shape[0]

    @property
    def slots(self) -> int:
        return self.blocks.shape[1]

    @property
    def n_pad(self) -> int:
        return self.n_block_rows * self.block_size

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """Y = A X for X (n_pad, m): gather each slot's X block (a zero
        block for the sentinel), one batched (bs x bs) @ (bs x m) product
        per slot, sum over the slots.  The plain version of kernel B3."""
        _backend.count_plain("bsr_spmm", x)
        bs = self.block_size
        xb = torch.cat([x.reshape(-1, bs, x.shape[1]),
                        x.new_zeros((1, bs, x.shape[1]))])
        gathered = xb[self.block_cols.long()]  # (R, S, bs, m)
        return torch.matmul(self.blocks, gathered).sum(1).reshape(
            self.n_pad, x.shape[1])

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x for x (n_pad,): ``matmat`` with one column."""
        return self.matmat(x[:, None])[:, 0]

    @staticmethod
    def from_blocks(block_rows: np.ndarray, block_cols: np.ndarray,
                    blocks: np.ndarray, n_block_rows: int,
                    dtype=torch.float32, device=None) -> "BSRMatrix":
        """Assemble from (block row, block column, dense block) triples, as
        ``scipy``'s ``tobsr`` would block the matrix they make: blocks that
        share a (row, column) pair are summed (in the blocks' dtype, in
        list order) into one slot, and the slots of a block row keep the
        order in which their column first occurs."""
        r, bs = n_block_rows, blocks.shape[1]
        layout = _SlotLayout.of(block_rows, block_cols, r)
        out = np.zeros((r, layout.slots, bs, bs), blocks.dtype)
        site = layout.row * layout.slots + layout.slot
        first = np.zeros(site.shape[0], bool)
        first[np.unique(site, return_index=True)[1]] = True
        out[layout.row[first], layout.slot[first]] = blocks[first]
        np.add.at(out, (layout.row[~first], layout.slot[~first]),
                  blocks[~first])  # repeats, in list order
        return BSRMatrix(
            blocks=torch.from_numpy(out).to(dtype=dtype, device=device),
            block_cols=torch.from_numpy(layout.cols).to(device),
            n=r * bs,
        )

    @staticmethod
    def from_scipy(mat, block_size: int = 128, slots: int | None = None,
                   dtype=torch.float32, device=None) -> "BSRMatrix":
        """The reference's ``BSRMatrix.from_scipy``: pad to a multiple of
        ``block_size`` and block the rows as ``scipy``'s ``tobsr`` does
        (an entry stored in the CSR, an explicit zero included, opens its
        block; slots in order of first occurrence; ``slots`` defaults to
        the fullest block row's count).  The blocks are filled in ``dtype`` directly,
        without the reference's float64 staging array; entries that share
        a position are summed in float64 first, so a float64 matrix gives
        the reference's blocks after its cast."""
        n = mat.shape[0]
        bs = block_size
        r = -(-n // bs)
        csr = mat.tocsr()
        if r * bs > n:  # the reference pads through sp.bmat: sorted rows
            csr = sp.bmat([[csr, None],
                           [None, sp.csr_matrix((r * bs - n, r * bs - n))]]
                          ).tocsr()
        rows = np.repeat(np.arange(r * bs), np.diff(csr.indptr))
        cols = csr.indices.astype(np.int64)
        layout = _SlotLayout.of(rows // bs, cols // bs, r, slots)
        flat = (((layout.row * layout.slots + layout.slot) * bs + rows % bs)
                * bs + cols % bs)
        sites, at = np.unique(flat, return_inverse=True)
        sums = np.bincount(at, weights=csr.data.astype(np.float64))
        blocks = np.zeros(r * layout.slots * bs * bs,
                          np.float64 if dtype == torch.float64
                          else np.float32)
        blocks[sites] = sums
        return BSRMatrix(
            blocks=torch.from_numpy(
                blocks.reshape(r, layout.slots, bs, bs)).to(
                    dtype=dtype, device=device),
            block_cols=torch.from_numpy(layout.cols).to(device),
            n=n,
        )


@dataclass
class _SlotLayout:
    """Where each stored item (entry or block) of a block-sparse matrix
    goes: its block row and slot, the (R, S) block-column table with the
    sentinel R on empty slots, and S."""

    row: np.ndarray
    slot: np.ndarray
    cols: np.ndarray
    slots: int

    @staticmethod
    def of(block_rows: np.ndarray, block_cols: np.ndarray, r: int,
           slots: int | None = None) -> "_SlotLayout":
        key = block_rows.astype(np.int64) * (r + 1) + block_cols
        uniq, first, inverse = np.unique(key, return_index=True,
                                         return_inverse=True)
        u_row = uniq // (r + 1)
        order = np.lexsort((first, u_row))  # by row, then first occurrence
        counts = np.bincount(u_row, minlength=r)
        need = max(int(counts.max(initial=1)), 1)
        if slots is not None and slots < need:
            raise ValueError(f"{slots} slots for {need} blocks in a row")
        slots = need if slots is None else slots
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        slot = np.empty(uniq.shape[0], np.int64)
        slot[order] = np.arange(uniq.shape[0]) - starts[u_row[order]]
        cols = np.full((r, slots), r, np.int32)
        cols[u_row, slot] = uniq % (r + 1)
        return _SlotLayout(row=u_row[inverse], slot=slot[inverse], cols=cols,
                           slots=slots)
