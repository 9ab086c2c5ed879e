"""The plain PyTorch reference that decides a run's ``correct``; imports nothing of the port."""
