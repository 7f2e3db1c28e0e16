"""Serving layer of the PyTorch port: engine, step functions, scheduler."""
