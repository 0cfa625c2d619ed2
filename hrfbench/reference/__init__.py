"""The benchmark's plain reference of the port's train step and render
function: plain PyTorch, no kernel, no CUDA graph, importing nothing of the
port. The modules are a frozen copy of the port's plain (CPU) path at the
commit that defined the benchmark, so a later change to the port cannot
change what it is held to; `fused_field.py` replaces the port's kernels by
autograd over `torch.gather`, and `check.py` is the harness's entry.
"""
