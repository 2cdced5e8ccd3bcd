"""End-to-end metrics, one reader each, found by the metric's name in
``BENCHMARK.json``; ``read(window, setup_s)`` returns the number or
None where the traffic delivers nothing it measures."""
