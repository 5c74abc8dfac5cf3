"""The sharded prover on ``torch.distributed``: one process per device
(counterpart of stark_tpu/parallel/).  mesh.py holds the mesh and its
collectives, distributed.py starts the process group, pntt.py is the
four-step NTT over the mesh, pmerkle.py the sharded trees and query
gather, pstark.py the sharded FRI and prover."""

from stark_tpu_torch.parallel.distributed import global_mesh, initialize_distributed
from stark_tpu_torch.parallel.mesh import Mesh, Shard, make_mesh, replicated
from stark_tpu_torch.parallel.pmerkle import (
    ShardedForest,
    ShardedGather,
    sharded_tree_from_rows,
    sharded_tree_from_values,
)
from stark_tpu_torch.parallel.pntt import (
    sharded_coset_eval,
    sharded_coset_interp,
    sharded_intt,
    sharded_lde,
    sharded_ntt,
)
from stark_tpu_torch.parallel.pstark import (
    DistributedStarkProver,
    DistributedStarkVerifier,
    ShardedFri,
)

__all__ = [
    "DistributedStarkProver",
    "DistributedStarkVerifier",
    "Mesh",
    "Shard",
    "ShardedForest",
    "ShardedFri",
    "ShardedGather",
    "global_mesh",
    "initialize_distributed",
    "make_mesh",
    "replicated",
    "sharded_coset_eval",
    "sharded_coset_interp",
    "sharded_intt",
    "sharded_lde",
    "sharded_ntt",
    "sharded_tree_from_rows",
    "sharded_tree_from_values",
]
