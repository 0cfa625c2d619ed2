"""PyTorch/CUDA port of humanrf_tpu for NVIDIA Hopper GPUs.

Keeps the JAX package's module layout and names; imports torch and never jax.
The port covers what the JAX package does: the CLI (`run.py`: training with
validation and checkpoints in the JAX format, the trajectory and evaluate
phases, the light-bloom filter, TensorBoard events and a profiler trace),
both samplers (dense and proposal) in `train/pipeline.py`, the render of a
trained model, the data toolbox (`toolbox/`), and multi-GPU training,
data-parallel or with the segment tables sharded (`parallel/`). Every field
query runs on the hand-written CUDA kernels of `csrc/field_interp.cu`.
"""
