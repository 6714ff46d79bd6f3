"""Parallelism over ``torch.distributed`` (counterpart of ``parallel/``):
``multihost`` (the process group from the ``env://`` variables that
``torchrun`` sets, object gathers, barriers) and ``mesh`` (the ranks as a
(dp, view) grid, a batch's block for a rank, the cross-view gather)."""
from .mesh import (Mesh, gather_views, make_mesh, shard_batch,
                   sharded_views, view_mesh)
from .multihost import (COLLECTIVES, all_gather_objects, barrier,
                        initialize_if_needed, process_count, process_index,
                        rank_device)

__all__ = ["COLLECTIVES", "Mesh", "all_gather_objects", "barrier",
           "gather_views", "initialize_if_needed", "make_mesh",
           "process_count", "process_index", "rank_device", "shard_batch",
           "sharded_views", "view_mesh"]
