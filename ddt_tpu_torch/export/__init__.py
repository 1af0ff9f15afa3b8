"""Servable artifacts for the registry (export/aot.py)."""
