"""vulkan_pathtracer_tpu_torch — the PyTorch + CUDA port of the path tracer.

A second package beside ``vulkan_pathtracer_tpu`` (the JAX reference,
which stays as it is).  It renders the same single frame with the same
numbers: plain tensor code is PyTorch, and the two BVH traversal
kernels the frame runs are hand-written CUDA C++ for Hopper
(``csrc/stack_traverse.cu``).

Layer map (same names as the JAX package, so each module's
counterpart is easy to find):

- ``ops``    — RNG, vector math, packing, intersection, texture,
               BRDF, wavefront sort, and the quad-BVH traversal
               (``stack_traverse`` with its kernels in ``kernels``).
- ``models`` — glTF loader and the flat device-scene bake.
- ``render`` — shading fetch, the wavefront bounce loop, the frame
               pipeline.
- ``app``    — the headless CLI (``python -m vulkan_pathtracer_tpu_torch``).

No module imports ``jax``.  Host-only modules of the JAX package that
are free of JAX (BVH build, native library, camera, config, CLI, PNG)
are reused by import.
"""

__version__ = "0.1.0"
