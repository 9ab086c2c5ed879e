from .mesh import (Mesh, SeedDataMesh, data_parallel_mesh, initialize_multihost, launch,
                   replicate, seed_data_mesh, shard_batch)

__all__ = ["Mesh", "SeedDataMesh", "data_parallel_mesh", "initialize_multihost", "launch",
           "replicate", "seed_data_mesh", "shard_batch"]
