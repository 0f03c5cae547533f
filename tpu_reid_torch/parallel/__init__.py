"""Extraction, prefetch and the data mesh over ranks (mesh.py, launch.py,
multihost.py)."""
