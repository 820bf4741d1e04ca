"""watchtower: online drift monitoring of the served scores.

- :mod:`baseline` — the train-time histogram profile beside ``model.npz``;
- :mod:`drift` — the device-resident decayed window, folded inside the
  serving flush, and its PSI/KS/ECE statistics;
- :mod:`shadow` — the ``@shadow`` challenger re-scoring a sample of live
  batches off the request path;
- :mod:`watchtower` — the coordinator behind ``/monitor/status`` and the
  retrain trigger.
"""
