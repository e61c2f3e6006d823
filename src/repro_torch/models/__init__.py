"""The LM stack's serving path (dense GQA family) on PyTorch."""
