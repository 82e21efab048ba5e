"""Multi-device training and generation over torch.distributed."""
