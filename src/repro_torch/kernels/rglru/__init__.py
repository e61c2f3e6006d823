"""RG-LRU diagonal linear recurrence (CUDA kernel B4)."""
