"""The plain float32 reference of the benchmark (imports nothing of the program)."""
