"""The roofline of a cell on the H100: analytic compute and memory terms
(``analytic``), the sync's bytes counted from the plans and the terms in
seconds (``analysis``), and the table (``report``)."""
from .analysis import (CollectiveStats, Roofline, SyncCount,  # noqa: F401
                       analyze, combined, model_flops, sync_counts,
                       tp_counts)
from .analytic import CellSpec, analytic_cell  # noqa: F401
