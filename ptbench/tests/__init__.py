"""CPU and card tests of the benchmark (``python -m pytest ptbench/tests``)."""
