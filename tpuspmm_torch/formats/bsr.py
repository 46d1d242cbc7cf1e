"""Block Sparse Row container (counterpart of ``tpuspmm.formats.BSR``).

``nnz`` is the header's stored-entry count (nblocks·bh·bw for a container
built here), not the count of non-zeros: ``sparsity``, the dispatcher's
densify admission and the records' GFLOP/s follow from it, as in the JAX
package.  The COO view keeps the explicit zeros inside stored blocks, as
scipy's ``bsr.tocsr()`` does, so every plan built from a BSR equals the JAX
package's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from tpuspmm_torch.formats.base import MatrixBase
from tpuspmm_torch.formats import io as fio


@dataclasses.dataclass(frozen=True)
class BSR(MatrixBase):
    indptr: np.ndarray   # (num_block_rows+1,) int32
    indices: np.ndarray  # (nblocks,) int32, block-column index per block
    blocks: np.ndarray   # (nblocks, bh, bw) float32
    shape: Tuple[int, int] = (0, 0)
    block_size: Tuple[int, int] = (1, 1)
    nnz: int = 0  # stored entries (header field)

    format_name = "bsr"

    @property
    def num_block_rows(self) -> int:
        return self.shape[0] // self.block_size[0]

    @property
    def nblocks(self) -> int:
        return int(self.blocks.shape[0])

    @classmethod
    def from_file(cls, path: str) -> "BSR":
        """Load the reference `.bsr` text format."""
        shape, nnz, bs, indptr, indices, blocks = fio.read_bsr_text(path)
        return cls(indptr=indptr, indices=indices, blocks=blocks,
                   shape=shape, block_size=bs, nnz=nnz)

    @classmethod
    def from_scipy(cls, m, block_size: Tuple[int, int] = (4, 4)) -> "BSR":
        """Halves each block side until it divides the shape (the reference
        converter's fallback, down to 1)."""
        bh, bw = block_size
        rows, cols = m.shape
        while bh > 1 and rows % bh != 0:
            bh //= 2
        while bw > 1 and cols % bw != 0:
            bw //= 2
        m = m.tobsr(blocksize=(bh, bw))
        return cls(indptr=m.indptr.astype(np.int32),
                   indices=m.indices.astype(np.int32),
                   blocks=m.data.astype(np.float32), shape=tuple(m.shape),
                   block_size=tuple(m.blocksize), nnz=int(m.nnz))

    @classmethod
    def from_dense(cls, dense: np.ndarray,
                   block_size: Tuple[int, int] = (4, 4)) -> "BSR":
        import scipy.sparse

        return cls.from_scipy(scipy.sparse.csr_matrix(np.asarray(dense)),
                              block_size)

    @classmethod
    def random_blocks(cls, rows: int, cols: int, block_size: Tuple[int, int],
                      block_density: float, seed: int = 0) -> "BSR":
        """Random block-sparse matrix: dense standard-normal blocks at a
        block-level density (the JAX package's draws from the same seed)."""
        rng = np.random.default_rng(seed)
        bh, bw = block_size
        assert rows % bh == 0 and cols % bw == 0
        nbr, nbc = rows // bh, cols // bw
        mask = rng.random((nbr, nbc)) < block_density
        indptr = np.zeros(nbr + 1, dtype=np.int32)
        indptr[1:] = np.cumsum(mask.sum(axis=1)).astype(np.int32)
        indices = np.nonzero(mask)[1].astype(np.int32)  # row-major order
        nblocks = int(indptr[-1])
        blocks = rng.standard_normal((nblocks, bh, bw)).astype(np.float32)
        return cls(indptr=indptr, indices=indices, blocks=blocks,
                   shape=(rows, cols), block_size=(bh, bw),
                   nnz=nblocks * bh * bw)

    def to_scipy(self):
        import scipy.sparse

        return scipy.sparse.bsr_matrix(
            (self.blocks, self.indices, self.indptr), shape=self.shape)

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray().astype(np.float32)

    def to_csr(self):
        from tpuspmm_torch.formats.csr import CSR

        return CSR.from_scipy(self.to_scipy().tocsr())

    def to_coo(self):
        """The CSR view's triplets, explicit zeros of stored blocks kept."""
        return self.to_csr().to_coo()

    def save(self, path: str):
        fio.write_bsr_text(path, self.shape, self.nnz, self.block_size,
                           self.indptr, self.indices, self.blocks)
