"""Terrain grid and height lookups of the port (``terrain/composer.py``)."""
