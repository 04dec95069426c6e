"""The port's remote filesystems (``io/s3_filesys.py``, ``hdfs_filesys.py``,
``azure_filesys.py``, ``gcs_filesys.py``, ``http_filesys.py`` over
``io/http_util.py``) on the CPU, against in-process fake servers.

``tests/test_remote_fs.py`` is loaded against the port whole
(``*_port``): each backend's round trip (write, ranged read, listing,
a sharded RecordIO ``InputSplit`` over the remote listing), S3
multipart with a part retried, the fault matrices, client-side fault
injection, abort on an exception, the SigV4 known vector, the read-only
HTTP backend and its range probe.

The port's own check: importing ``dmlc_core_tpu_torch.io`` registers the
JAX package's protocols, each to the port's backend class.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import dmlc_core_tpu.io  # noqa: E402,F401
import dmlc_core_tpu_torch.io  # noqa: E402,F401
from _torch_suites import export, load_port  # noqa: E402
from dmlc_core_tpu.io.filesystem import FS_REGISTRY as JAX_FS  # noqa: E402
from dmlc_core_tpu_torch.io.filesystem import FS_REGISTRY  # noqa: E402

_REMOTE = load_port("test_remote_fs.py")
export(globals(), _REMOTE, funcs=[n for n in dir(_REMOTE)
                                  if n.startswith("test_")])
serve = _REMOTE.serve


def test_protocols_are_the_jax_packages():
    assert FS_REGISTRY.list_all_names() == JAX_FS.list_all_names()
    for proto in JAX_FS.list_all_names():
        ours = FS_REGISTRY.find(proto)
        assert ours.__module__.startswith("dmlc_core_tpu_torch.io"), proto
