"""Multi-device planes of the port. ``collective_agg`` is the device
aggregation plane of the collective federated runner
(``federation/collective_round.py``) on ``torch.distributed``; ``mesh``,
``context``, ``sharding``, ``spmd`` and ``pipeline`` are model parallelism
inside a client (a ``Trainer`` on a mesh), and ``autotune`` picks a
client's layout."""

from photon_tpu_torch.parallel.collective_agg import (  # noqa: F401
    ClientMesh,
    DeviceAggregationPlane,
    make_client_mesh,
    make_hierarchical_mesh,
)
