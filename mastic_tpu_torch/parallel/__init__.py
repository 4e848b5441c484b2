"""Report sharding over `torch.distributed` (port of
`mastic_tpu/parallel/`): the mesh (`mesh.py`), the node axis's split of
the from-root rounds (`grid.py`), the ranks' launcher (`launch.py`) and
the rank programs of the tests, the multichip tool
and the card's smoke (`jobs.py`, imported by name: it imports the
drivers, which import this package)."""

from .grid import install_grid_sharding
from .launch import spawn
from .mesh import (Gathered, ReportMesh, gather_round, gather_rows,
                   make_mesh, place_replicated, place_reports,
                   shard_incremental_runner, sharded_gen, sharded_prep,
                   sharded_round, sum_shares)

__all__ = ["Gathered", "ReportMesh", "gather_round", "gather_rows",
           "install_grid_sharding", "make_mesh", "place_replicated",
           "place_reports", "shard_incremental_runner", "sharded_gen",
           "sharded_prep", "sharded_round", "spawn", "sum_shares"]
