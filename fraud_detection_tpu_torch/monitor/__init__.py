"""watchtower: online drift monitoring of the served scores.

- :mod:`baseline` — the train-time histogram profile beside ``model.npz``;
- :mod:`drift` — the device-resident decayed window, folded inside the
  serving flush, and its PSI/KS/ECE statistics;
- :mod:`watchtower` — the coordinator behind ``/monitor/status``.

Shadow scoring and the retrain trigger are not ported yet.
"""
