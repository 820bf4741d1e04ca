"""Small standard-library utilities (``lockdep``, ``jsonlog``) and the
device trace (``profiling``)."""
