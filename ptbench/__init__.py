"""The benchmark of the PyTorch and CUDA path tracer
(``vulkan_pathtracer_tpu_torch``): ``python -m ptbench.run``; see
README.md."""
