"""The plain float32 reference that decides ``correct``: PyTorch only, and
nothing of the program under test."""
