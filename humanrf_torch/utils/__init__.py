"""Random draws keyed by integer identity (threefry-2x32, as the JAX package draws them)."""
