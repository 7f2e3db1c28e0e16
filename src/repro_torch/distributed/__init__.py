"""Distributed layer of the PyTorch port: sharding plans over device
meshes, the collectives of the local bodies, and gradient compression."""
