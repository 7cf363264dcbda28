"""Synthetic data pipeline (a copy of ``repro.data``: numpy only, so both
packages see the same batches)."""
from .pipeline import DataConfig, SyntheticPipeline, for_model  # noqa: F401
