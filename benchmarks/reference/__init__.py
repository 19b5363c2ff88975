"""The plain reference: float32 PyTorch and numpy, no kernel of the program."""
