"""The plain reference the benchmark holds the program against: NumPy
sampling and plain PyTorch float32 model, loss and AdamW, model-centric.
It imports nothing of the program."""
