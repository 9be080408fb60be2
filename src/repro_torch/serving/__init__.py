"""Batched query serving."""
from repro_torch.serving.batched import (BatchSearchResult, batch_probe,
                                         ssh_search_batch)

__all__ = ["BatchSearchResult", "batch_probe", "ssh_search_batch"]
