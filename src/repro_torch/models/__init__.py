"""Model building blocks of the PyTorch port (see ``repro_torch``)."""
