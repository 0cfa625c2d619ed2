"""Render and training pipeline, losses, optimizer, checkpoint reading and image rendering."""
