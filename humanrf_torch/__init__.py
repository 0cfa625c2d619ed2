"""PyTorch/CUDA port of humanrf_tpu for NVIDIA Hopper GPUs.

Keeps the JAX package's module layout and names; imports torch and never jax.
The port covers the render path of a trained model
(`train.trainer.render_image` over `train.pipeline.make_render_fn`) and the
flagship training step (`train.pipeline.make_train_step` with
`train.trainer.make_optimizer`).
"""
