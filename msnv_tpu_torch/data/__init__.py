"""Data helpers of the port (WAV bytes)."""
