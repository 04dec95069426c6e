"""I/O layer: Stream API with URI dispatch, memory streams, filesystems
(local files, ``mem://`` and the remote ``s3://``, ``hdfs://``,
``azure://``, ``gs://`` and ``http(s)://`` backends), the binary
serializer, JSON helpers, RecordIO, input splits, the threaded prefetch
iterator, the thread group and the lock-free queue — the port's own
copies of the JAX package's host modules, exported under the same names.

Reference parity: include/dmlc/{io,memory_io,serializer,json,recordio,
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
from dmlc_core_tpu_torch.io.thread_group import ThreadGroup, ShutdownEvent  # noqa: F401
from dmlc_core_tpu_torch.io.recordio import (  # noqa: F401
    RecordIOWriter,
    RecordIOReader,
    RecordIOChunkReader,
    RECORDIO_MAGIC,
)
from dmlc_core_tpu_torch.io.input_split import InputSplit  # noqa: F401
from dmlc_core_tpu_torch.io.lockfree import (  # noqa: F401
    BlockingConcurrentQueue,
    ConcurrentQueue,
    QueueKilledError,
    Spinlock,
)

# remote backends self-register their URI protocols on import
from dmlc_core_tpu_torch.io.s3_filesys import S3FileSystem  # noqa: F401
from dmlc_core_tpu_torch.io.hdfs_filesys import HDFSFileSystem  # noqa: F401
from dmlc_core_tpu_torch.io.azure_filesys import AzureFileSystem  # noqa: F401
from dmlc_core_tpu_torch.io.gcs_filesys import GCSFileSystem  # noqa: F401
from dmlc_core_tpu_torch.io.http_filesys import HttpFileSystem  # noqa: F401
