"""The port's benchmark harness: `common` (sweeps through the engine's
public API, the port's bench file) and `smoke` (the smoke path,
``python -m repro_torch.bench.smoke``)."""
