"""I/O layer: Stream API with URI dispatch, memory streams, filesystems
(local files and ``mem://``), the binary serializer, RecordIO, input
splits and the threaded prefetch iterator — the port's own copies of the
JAX package's host modules, exported under the same names.

Reference parity: include/dmlc/{io,memory_io,serializer,recordio,
threadediter,concurrency,filesystem}.h and src/io/* (SURVEY.md §2a-b).
"""

from dmlc_core_tpu_torch.io.stream import Stream, SeekStream, Serializable  # noqa: F401
from dmlc_core_tpu_torch.io.memory_io import (  # noqa: F401
    MemoryFixedSizeStream,
    MemoryStringStream,
)
from dmlc_core_tpu_torch.io.filesystem import (  # noqa: F401
    URI,
    FileInfo,
    FileSystem,
    LocalFileSystem,
    TemporaryDirectory,
)
from dmlc_core_tpu_torch.io.threaded_iter import ThreadedIter  # noqa: F401
from dmlc_core_tpu_torch.io.concurrency import ConcurrentBlockingQueue  # noqa: F401
from dmlc_core_tpu_torch.io.recordio import (  # noqa: F401
    RecordIOWriter,
    RecordIOReader,
    RecordIOChunkReader,
    RECORDIO_MAGIC,
)
from dmlc_core_tpu_torch.io.input_split import InputSplit  # noqa: F401
