"""Offline tools: occupancy carving, dataset import and scene exporters."""
