"""Launchers of the port's entry points, run as paths (``python/binary.py``
runs a binary that ends in ``.py`` as ``[python, path, config]``)."""
