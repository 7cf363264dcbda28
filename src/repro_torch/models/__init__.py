"""Models of the port: every architecture family of the reference."""
from .config import ModelConfig, ShardingRecipe  # noqa: F401
from .registry import (ModelApi, build, is_ep, leaf_dtype,  # noqa: F401
                       make_param_specs, param_shapes, value_and_grad,
                       value_and_grad_ranks)
