"""Fault tolerance of the port: the straggler watchdog, rank-level
failure injection and the elastic recovery controller."""
from .watchdog import Watchdog, WatchdogConfig  # noqa: F401
from .failures import (CheckpointIOError, FailureInjector,  # noqa: F401
                       FailurePlan, FaultEvent, RankFailure, SimulatedFailure)
from .elastic import (PHASES, ElasticAbort, ElasticConfig,  # noqa: F401
                      ElasticController, RecoveryReport, ReplanRecord,
                      active_specs)
