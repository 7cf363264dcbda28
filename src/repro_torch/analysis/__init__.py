"""Static analysis of the port's collective plans: the plan verifier
(``verify``), behind ``python -m repro_torch.analysis --verify``.

The reference's other passes (``jaxpr_lint``, ``hlo_budget``) read
traced jaxprs and compiled HLO, which the port does not have; its
exchange and byte counters (``comm.exchanges``, ``comm.bytes``) are
checked by the conformance harness instead.
"""
from .report import Finding, Report  # noqa: F401

__all__ = ["Finding", "Report"]
