"""The port's counterparts of the reference's `examples/`: ``python -m
repro_torch.examples.<name> [--device cpu]`` (`quickstart`,
`simulate_paper`, `serve_geo`), on the card unless told otherwise."""
