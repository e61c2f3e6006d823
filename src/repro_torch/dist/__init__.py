"""Distributed-training substrate (port of `repro.dist`): so far the
one-round-commit checkpoints; sharding, elastic membership and gradient
compression come with the mesh (ROADMAP.md §A item A7)."""
