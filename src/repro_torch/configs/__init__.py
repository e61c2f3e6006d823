"""Model configurations: `registry.get(name)` / `registry.reduced(name)`."""
