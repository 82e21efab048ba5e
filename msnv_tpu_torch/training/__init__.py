"""Training: the optimizer, the TBPTT steps, the Trainer loop, plugins and
checkpoints."""
