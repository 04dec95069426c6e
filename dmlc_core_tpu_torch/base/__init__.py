"""Base utilities: logging, parameters, registries (own copies)."""
