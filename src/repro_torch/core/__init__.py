"""Host-side (numpy) control logic of the PyTorch port."""
