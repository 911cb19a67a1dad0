"""Data parallelism and the query-sharded search on ``torch.distributed``
(twin of ``rdmnet_tpu/parallel``)."""

from rdmnet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    initialize_distributed,
    is_main,
    make_mesh,
    rank,
    replicate,
    world,
)
from rdmnet_tpu_torch.parallel.sharded_search import sharded_radius_knn  # noqa: F401
