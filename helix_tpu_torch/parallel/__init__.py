"""Multi-device scale-out: sharded search, graph traversal and index
construction over a device mesh (PyTorch port of ``helix_tpu.parallel``;
the mesh design is in :mod:`helix_tpu_torch.parallel.mesh`)."""

from .build import ShardedKMeans  # noqa: F401
from .graph import ShardedGraph  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh, device_count, make_mesh, virtual_devices,
)
from .sharded import ShardedVectorSearch  # noqa: F401
