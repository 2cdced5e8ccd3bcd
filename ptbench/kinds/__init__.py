"""Traffic kinds beyond the three that ``traffic.py`` holds, one module
each, found by the mix's ``kind``: ``kinds/<kind>.py`` defines

- ``warm_up(client)``: the mix's own shapes, once each, before the
  window (the client synchronises after it);
- ``loop(client, win, more)``: the measured window.  While
  ``more(win)`` holds, it drives ``client.pipe`` (the program's
  pipeline; ``client.tr`` the ``traffic.Traffic`` of the seed,
  ``client.steps`` the host steps to log, ``client.cam_type`` and
  ``client.acc_type`` the program's types) and counts what it
  delivered in ``win`` (``units``, ``frames``, ``spp``, ``frame_ms``)
  and keeps a seeded sample of its outputs in ``win.kept``, each as a
  frame (``index``, ``frame``, ``values``) or as a still (``index``,
  ``frame0``, ``spp``, ``values``), which ``check.py`` compares;
- ``SMALL``: the mix's entries for the CPU tests' small runs
  (``tests/conftest.small_mix``), such as a shorter batch or group.
"""
