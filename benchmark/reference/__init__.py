"""The benchmark's plain references: float32 PyTorch and numpy, written from
the published models' descriptions. Nothing here imports the program or
takes what the program made; the benchmark hands both sides the same
inputs."""
