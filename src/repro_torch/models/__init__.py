"""Models of the port: the SAR CNN (``sar_cnn.py``) and the dense
transformer LM (``transformer.py`` over ``blocks.py`` and
``attention.py``; ``registry.get_api`` dispatches by family)."""
