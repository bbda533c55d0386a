"""Plain PyTorch OSVOS, independent of ``osvos_torch``, that decides
``correct``: it imports neither JAX nor anything of the program."""
