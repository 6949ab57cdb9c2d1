"""Entry points of the PyTorch port (``serve``: the inference engine)."""
