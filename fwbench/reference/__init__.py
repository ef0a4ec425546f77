"""Plain references of the configurations, in PyTorch on the CPU; nothing
here imports the program under test."""
