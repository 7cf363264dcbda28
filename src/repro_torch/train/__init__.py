"""Train-step builders of the port."""
from .steps import (BuiltStep, build_fsdp_auto, build_single,  # noqa: F401
                    build_zero1)
