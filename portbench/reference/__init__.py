"""The plain reference the benchmark holds the program against: plain
PyTorch, no kernel, nothing of ``repro_torch``."""
