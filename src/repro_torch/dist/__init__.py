"""Distributed substrate (port of `repro.dist`): sharding rules and the
worlds mesh's placement (`sharding`), GeoTP one-round-commit checkpointing
(`checkpoint`), gradient compression (`compression`) and elastic resizing
(`elastic`).

The checkpoint manager mirrors the paper's commit-protocol insight at the
training layer: every host writes its shard (decentralized prepare — the
write IS the vote), then a single atomic commit marker finalizes the step,
so recovery never needs a second round of coordination.
"""
