"""Atomic, async, elastic checkpoints of the port's training state."""
from .manager import (CheckpointError, CheckpointManager,  # noqa: F401
                      config_fingerprint, reshard_flat)
