"""The streaming pool data loader."""
