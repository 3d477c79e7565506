"""NumPy reference aligners (the port's copy of tpu_align/oracle): the
engine's path for pairs with an empty side and for all-paths output, the
golden generator (verify/golden.py) and the tests' oracle.

  scalar.py     -- cell-at-a-time fill, the reference recurrences and `>=`
                   tie-break semantics ("cuda" or "cpu" tie policy)
  vectorized.py -- row-sweep NumPy fill, bit-identical to scalar.py, and
                   its cross-pair batched form (fill_vectorized_batch)
  traceback.py  -- direction matrices -> alignment strings, one path or
                   every co-optimal path
  lcs.py        -- longest common subsequence, every co-optimal one
"""

from tpu_align_torch.oracle.api import align_batch, align_pair
from tpu_align_torch.oracle.lcs import lcs, lcs_matrix
from tpu_align_torch.oracle.scalar import fill_scalar
from tpu_align_torch.oracle.traceback import lnw_all_paths, traceback_pair
from tpu_align_torch.oracle.vectorized import (
    fill_vectorized,
    fill_vectorized_batch,
)

__all__ = ["fill_scalar", "fill_vectorized", "fill_vectorized_batch",
           "traceback_pair", "lnw_all_paths", "align_pair", "align_batch",
           "lcs", "lcs_matrix"]
