"""Data of the port: synthetic SARD patches (``sard.py``) and the
synthetic token pipeline (``tokens.py``)."""
