"""Model artifact persistence (``model.npz`` + ``feature_names.json``)."""
