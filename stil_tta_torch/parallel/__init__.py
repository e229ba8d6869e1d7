"""Data parallelism over ``torch.distributed`` with the JAX mesh's
global-batch semantics (the port of ``stil_tta_tpu/parallel``):
:mod:`~stil_tta_torch.parallel.mesh` sets up the process group and the
mesh, :mod:`~stil_tta_torch.parallel.collectives` holds what runs across
the ranks."""

from stil_tta_torch.parallel.collectives import (active_mesh, active_shard,
                                                 sharded)
from stil_tta_torch.parallel.mesh import (Mesh, backend_for,
                                          create_hybrid_mesh, create_mesh,
                                          init_process_group, replicate)

__all__ = ["Mesh", "active_mesh", "active_shard", "backend_for",
           "create_hybrid_mesh", "create_mesh", "init_process_group",
           "replicate", "sharded"]
