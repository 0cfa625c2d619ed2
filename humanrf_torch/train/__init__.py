"""Render pipeline, checkpoint reading and image rendering."""
