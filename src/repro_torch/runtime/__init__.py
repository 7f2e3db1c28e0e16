"""Fault plane of the PyTorch port: fault injection, the retrying
transfer engine, the dispatch watchdog and the degradation ladder."""
