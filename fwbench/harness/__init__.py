"""The benchmark's harness: cells by name (``cell``), a run (``runner``),
the trace's reduction (``trace``) and the roofline yardstick (``roofline``)."""
