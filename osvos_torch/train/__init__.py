"""Training of the port: grouped SGD with accumulation, parent training and
the one-shot online fine-tune."""
