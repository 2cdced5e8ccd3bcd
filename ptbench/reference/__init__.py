"""The plain reference of the benchmark's configurations: a path tracer
in plain PyTorch and NumPy that reads the scene's glTF itself, builds
its own tree and follows the reference renderer's formulas.  It imports
nothing of the program."""
