"""Core GeoTP algorithms (PyTorch port)."""
