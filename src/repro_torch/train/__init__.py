"""Train-step builders of the port."""
from .steps import BuiltStep, build_single, build_zero1  # noqa: F401
