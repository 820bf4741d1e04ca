"""Numerics of the serving slice: scaler, logistic parameters, linear SHAP,
the fused-score kernel and the bucketed scorer."""
