"""Modules of the port, the counterparts of the JAX package's ``models/``."""
