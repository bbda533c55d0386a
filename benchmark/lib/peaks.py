"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at its full
700 W power limit; a card set below it runs slower under load, so every
result names the card and its limit beside them."""

BF16_FLOPS = 989e12     # bf16 tensor-core FLOP/s
HBM_BYTES = 3.35e12     # HBM3 bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time of some work on the card: the larger of its bf16
    operations over the peak rate and its bytes over HBM bandwidth."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
