"""The synthetic token pipeline (numpy; the trainer moves its batches to
the device)."""
from .pipeline import DataConfig, SyntheticPipeline

__all__ = ["DataConfig", "SyntheticPipeline"]
