"""The plain reference the benchmark holds the system under test
against: numpy and PyTorch only, nothing of the program."""
