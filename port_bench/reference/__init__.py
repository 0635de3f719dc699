"""The plain reference: float32 PyTorch, independent of the program."""
