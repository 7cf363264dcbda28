"""Models of the port (the dense decoder family so far)."""
from .config import ModelConfig  # noqa: F401
from .registry import ModelApi, build, value_and_grad  # noqa: F401
