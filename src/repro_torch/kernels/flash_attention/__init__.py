"""Causal / sliding-window / chunk-local GQA prefill attention (CUDA kernel B3)."""
