"""Plan vocabulary and circulant collectives of the port."""
from .collectives import (allgather, allreduce, circulant_allgather,  # noqa: F401
                          circulant_allreduce, circulant_reduce_scatter,
                          reduce_scatter)
from .plan import CollectivePlan, RoundState, plan  # noqa: F401
from .schedule import (RoundPlan, allgather_plan, ceil_log2,  # noqa: F401
                       get_skips, reduce_scatter_plan)
from .spec import CollectiveSpec, as_spec  # noqa: F401
