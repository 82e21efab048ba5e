"""Objective evaluation metrics (MCD, F0 RMSE, V/UV error)."""
