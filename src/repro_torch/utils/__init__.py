"""Small helpers shared across the port (mirrors ``repro/utils``)."""
