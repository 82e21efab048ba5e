"""SampleRNN model, conditioner head and generation, in PyTorch."""
