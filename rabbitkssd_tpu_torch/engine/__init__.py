"""Pipelines of the port: sketching and all-vs-all distance."""
