from .mesh import (Mesh, data_parallel_mesh, initialize_multihost, launch, replicate,
                   shard_batch)

__all__ = ["Mesh", "data_parallel_mesh", "initialize_multihost", "launch", "replicate",
           "shard_batch"]
