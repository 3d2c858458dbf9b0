"""Plain PyTorch references; nothing here imports the measured package."""
