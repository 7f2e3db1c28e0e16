"""Data pipeline of the PyTorch port (``repro/data``)."""
