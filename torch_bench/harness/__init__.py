"""The harness: finds a cell's files by name (``spec``), drives the
program through set-up, the measured window and the check (``mrf_train``),
reads the profiler's trace (``trace``)."""
