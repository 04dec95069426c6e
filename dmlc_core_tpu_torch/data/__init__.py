"""Data layer: CSR row blocks, text parsers and row-block iterators, the
port's own copies of the JAX package's host data plane (numpy; no device
code).

Reference parity: ``include/dmlc/data.h`` (Row/RowBlock/Parser/RowBlockIter),
``src/data/*`` (row_block, text parsers, basic/disk row iters)
(SURVEY.md §2a-b).
"""

from dmlc_core_tpu_torch.data.row_block import Row, RowBlock, RowBlockContainer  # noqa: F401
from dmlc_core_tpu_torch.data.parsers import Parser  # noqa: F401
from dmlc_core_tpu_torch.data.iter import RowBlockIter  # noqa: F401
