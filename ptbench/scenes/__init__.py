"""Scene generators, one file each, found by a configuration's
``scene.generator``; each defines ``make(path, **params)``."""
