"""Distributed layer: named meshes over a ``torch.distributed`` world (one
process per GPU), rabit-shaped and axis collectives, the KVStore, elastic
recovery, sequence-parallel attention (ring, Ulysses), ZeRO and the
pipeline.  The JAX package's ``data_sharding`` / ``replicated_sharding``
(``NamedSharding``\\ s of one controller's device arrays) have no
counterpart: each rank holds its own blocks."""

from dmlc_core_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    create_mesh,
)
from dmlc_core_tpu_torch.parallel.collectives import (  # noqa: F401
    init,
    finalize,
    rank,
    world_size,
    is_distributed,
    allreduce,
    broadcast,
    allgather,
    barrier,
)
from dmlc_core_tpu_torch.parallel.kvstore import KVStore  # noqa: F401
from dmlc_core_tpu_torch.parallel.recovery import (  # noqa: F401
    ElasticSession, ElasticTracker, ElasticTrainer, RoundCheckpointer)
from dmlc_core_tpu_torch.parallel.ring_attention import (  # noqa: F401
    reference_attention, ring_attention)
from dmlc_core_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401
from dmlc_core_tpu_torch.parallel.zero import ZeroAdam, ZeroState  # noqa: F401
