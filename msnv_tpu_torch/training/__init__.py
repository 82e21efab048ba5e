"""Training: the optimizer and the TBPTT train / eval steps."""
