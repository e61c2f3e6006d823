"""Single-query GQA decode attention over a KV cache (CUDA kernel B2)."""
