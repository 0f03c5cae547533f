"""Extraction, prefetch and the ("data", "model") mesh over ranks (mesh.py,
launch.py, multihost.py, tensor parallelism in tp.py)."""
