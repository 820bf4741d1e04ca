"""One reader a metric: ``<metric>.py`` with ``read(run)``, returning the
value or None when the run holds nothing to read (the metric then stays
out of the result line)."""
