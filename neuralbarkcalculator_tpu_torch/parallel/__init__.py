"""Multi-process runs of the port: the process group, its collectives and
the (data, model) mesh (distributed.py), the halo exchange of a
width-partitioned forward (spatial.py), and cross-rank BatchNorm
(sync_bn.py)."""
from .distributed import (Mesh, World, initialize_distributed, make_mesh,
                          shutdown_distributed, single_process)

__all__ = ["Mesh", "World", "initialize_distributed", "make_mesh",
           "shutdown_distributed", "single_process"]
