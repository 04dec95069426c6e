"""Multi-tenant serving: many models, one fleet (doc/serving.md).

``registry`` — tenant-namespaced versions with LRU paging of warm
runners; ``policy`` — SLO classes and admission thresholds the router
enforces; ``instruments`` — the per-tenant metric rows the spool-merge
feeds the SLO scorecard.

The PyTorch port's copy of ``dmlc_core_tpu/serve/tenancy``: the same
names, env ABI (``DMLC_TENANT_*``), metric names and tenant checkpoint
file; :class:`TenantRegistry` and :func:`load_tenant_checkpoint` take
``device=`` (``None``: ``cuda``).
"""

from dmlc_core_tpu_torch.serve.tenancy.instruments import tenant_metrics
from dmlc_core_tpu_torch.serve.tenancy.policy import TenantPolicy
from dmlc_core_tpu_torch.serve.tenancy.registry import (TenantRegistry,
                                                  checkpoint_tenant_model,
                                                  load_tenant_checkpoint)

__all__ = ["TenantRegistry", "TenantPolicy", "tenant_metrics",
           "checkpoint_tenant_model", "load_tenant_checkpoint"]
