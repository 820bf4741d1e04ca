"""Traffic generators, one module a kind (``lane``, ``fit``); the mixes they
read are the data files under ``mixes/``."""
