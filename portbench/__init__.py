"""The port's benchmark: one cell a run, driven by the files under this
folder and the entries of ``BENCHMARK.json`` (see ``README.md``)."""
