"""Chunkwise mLSTM matrix-memory attention (CUDA kernel B5)."""
