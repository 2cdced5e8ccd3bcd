"""Per-layer metrics, one reader each, found by the metric's name in
``BENCHMARK.json`` up to its first dot (``traverse_ms.frame`` is read
by ``traverse_ms.py``).  A reader declares what it reads (``WRAP``,
``SAMPLE``, ``KERNELS``; see spans.py) and defines ``read(ctx)``,
which returns the number or None where it finds nothing to read."""
