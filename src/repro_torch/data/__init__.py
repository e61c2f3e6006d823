"""The synthetic LM data pipeline and its counter-based generator (port of `repro.data`)."""
