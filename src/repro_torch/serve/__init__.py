from .batching import BatchSlots, ContinuousBatcher, Request

__all__ = ["BatchSlots", "ContinuousBatcher", "Request"]
