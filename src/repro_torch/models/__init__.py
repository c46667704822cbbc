"""Models of the port: the SAR CNN (``sar_cnn.py``)."""
