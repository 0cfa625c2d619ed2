"""Offline tools: occupancy carving, the mesh renderer and the Alembic
extractor, dataset import and scene exporters."""
