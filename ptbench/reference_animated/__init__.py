"""The plain reference of the benchmark's animated configuration: the
glTF's node animation channels evaluated by its own code in float64,
the world triangles flattened at each frame's time, then the tree and
the path tracing of ``ptbench.reference``.  It imports nothing of the
program."""
