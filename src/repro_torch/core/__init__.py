"""Plan vocabulary, the circulant collectives and the baselines of the
port."""
from .collectives import (allgather, allgather_pipelined,  # noqa: F401
                          allreduce, alltoall, broadcast,
                          circulant_allgather, circulant_allreduce,
                          circulant_alltoall, circulant_alltoallv,
                          circulant_reduce_scatter, hierarchical_allgather,
                          hierarchical_allreduce,
                          hierarchical_reduce_scatter,
                          recursive_halving_reduce_scatter, reduce_scatter,
                          reduce_scatter_pipelined, ring_allreduce,
                          ring_reduce_scatter, xla_allgather, xla_allreduce,
                          xla_alltoall, xla_reduce_scatter)
from .plan import (BACKENDS, A2APlan, BlockLayout,  # noqa: F401
                   CollectivePlan, RoundState, plan)
from .schedule import (RoundPlan, allgather_plan, alltoall_moves,  # noqa: F401
                       ceil_log2, get_skips, reduce_scatter_plan)
from .spec import CollectiveSpec, as_spec  # noqa: F401
