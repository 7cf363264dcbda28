"""Plan vocabulary and circulant collectives of the port."""
from .collectives import (allgather, allreduce, alltoall,  # noqa: F401
                          circulant_allgather, circulant_allreduce,
                          circulant_alltoall, circulant_alltoallv,
                          circulant_reduce_scatter, reduce_scatter)
from .plan import A2APlan, CollectivePlan, RoundState, plan  # noqa: F401
from .schedule import (RoundPlan, allgather_plan, alltoall_moves,  # noqa: F401
                       ceil_log2, get_skips, reduce_scatter_plan)
from .spec import CollectiveSpec, as_spec  # noqa: F401
