"""Data parallelism over several cards (see parallel/mesh.py)."""
