"""Ray, occupancy, resampling and rendering ops, and the hand-written kernels."""
