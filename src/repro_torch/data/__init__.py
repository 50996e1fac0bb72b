"""The training data pipeline (`pipeline`): synthetic or file-backed token
batches, generated statelessly from (seed, step) and prefetched."""
from .pipeline import DataPipeline, FileSource, synthetic_tokens

__all__ = ["DataPipeline", "FileSource", "synthetic_tokens"]
