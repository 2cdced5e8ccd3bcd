"""vulkan_pathtracer_tpu_torch — the PyTorch + CUDA port of the path tracer.

A second package beside ``vulkan_pathtracer_tpu`` (the JAX reference,
which stays as it is).  It renders the same single frame with the same
numbers, flat or two-level (``--instanced``): plain tensor code is
PyTorch, and the four BVH traversal kernels those frames run are
hand-written CUDA C++ for Hopper (``csrc/stack_traverse.cu`` for the
quad table, ``csrc/pair_traverse.cu`` for the pair table).

Layer map (same names as the JAX package, so each module's
counterpart is easy to find):

- ``ops``    — RNG, vector math, packing, intersection, texture,
               BRDF, wavefront sort, the host BVH build (``bvh``,
               ``native``), and the quad- and pair-BVH traversal
               (``stack_traverse`` with its kernels in ``kernels``).
- ``models`` — glTF loader, camera, the flat device-scene bake and the
               two-level bake (``instanced_scene``).
- ``render`` — shading fetch, the wavefront bounce loop, the frame
               pipeline, the divider blit.
- ``app``    — the headless CLI (``python -m vulkan_pathtracer_tpu_torch``)
               and camera paths.
- ``utils``  — render configuration, CLI parser, PNG output.

No module imports ``jax`` or anything of the JAX package: the host-only
modules the port shares with it (BVH build, native library loader,
camera, config, CLI, PNG, divider blit) are the port's own copies.
"""

__version__ = "0.1.0"
