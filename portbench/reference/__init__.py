"""The plain reference of the benchmark's configurations: float32 PyTorch
written from the DG-SCT release's definitions, with the seeded weights
both sides are given. It imports nothing of the program."""
