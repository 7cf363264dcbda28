"""Models of the port (the dense and MoE decoder families so far)."""
from .config import ModelConfig  # noqa: F401
from .registry import (ModelApi, build, is_ep, value_and_grad,  # noqa: F401
                       value_and_grad_ranks)
