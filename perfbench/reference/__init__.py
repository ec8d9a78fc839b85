"""The plain PyTorch reference; it imports nothing of the program."""
