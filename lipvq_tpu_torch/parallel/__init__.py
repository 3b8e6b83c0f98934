"""Corpus-scale paths of the port (one card; no mesh)."""
