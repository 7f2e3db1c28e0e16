"""Training path of the PyTorch port: losses, AdamW, the train step and the
trainer (``repro/training``)."""
