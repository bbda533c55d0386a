"""Training of the port: grouped SGD and the one-shot online fine-tune."""
