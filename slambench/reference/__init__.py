"""Part of the port's benchmark (see slambench/run.py)."""
