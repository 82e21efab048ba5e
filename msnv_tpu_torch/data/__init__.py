"""Data pipeline of the port: WAV I/O, corpus build, chunk loader."""
