"""Small standard-library utilities (``lockdep``)."""
