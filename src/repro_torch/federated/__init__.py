"""The sharded MOCHA runtime: tasks sharded over the ranks of a
``torch.distributed`` process group, Delta v exchanged with one all-gather
a round (``runtime``), the task axis padded to the rank count
(``sharding``).  ``core.engine.ShardedEngine`` runs it under the driver."""
from repro_torch.federated.runtime import (all_gather_rows, distributed_round,
                                           make_federated_mesh)
from repro_torch.federated.sharding import (pad_task_matrix, pad_tasks,
                                            pad_vector)

__all__ = ["all_gather_rows", "distributed_round", "make_federated_mesh",
           "pad_task_matrix", "pad_tasks", "pad_vector"]
