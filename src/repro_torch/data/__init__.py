"""Data of the port: synthetic SARD patches (``sard.py``)."""
