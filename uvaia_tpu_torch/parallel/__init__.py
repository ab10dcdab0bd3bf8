"""Scans over several devices (mesh.py) and several processes
(multihost.py)."""
