"""Device kernels by the layer they belong to.

``kernel_group`` is frozen from ``chip_smoke.py``: the names of the port's
hand-written kernels (``osvos_torch/csrc/*.cu``) and of the library kernels
around them, mapped to the layer that launched them; the serving kernels,
B1 and I1, have groups of their own here.
"""

# the sequence launches of the packed schedule (roofline.seq_wgrad): in a
# packed step every wgrad.cu and stem_wgrad.cu kernel is one
SEQ_WGRAD = (
    "stem_wgrad.cu stem dK + db (B16)",
    "wgrad.cu dK (fast: B17; flat: B4, the dK + db of B3, and B6's dK)")
MEMCPY_HTOD = "Memcpy HtoD"


def kernel_group(name: str) -> str:
    """The layer a device kernel of a step or a pass belongs to."""
    if "tail_kernel<" in name:
        return "fused_head.cu fused-head tail (B1)"
    if "int8_conv3x3" in name:  # before flatconv's conv3x3_kernel<
        return "int8conv.cu int8 conv (I1)"
    if "side_fwd_tma_kernel<" in name:
        return "flatconv side forward (B5)"
    if "side_dgrad_tma_kernel<" in name:
        return "flatconv dz, side (B6)"
    if "pack_weight_kernel" in name:
        return "flatconv weight pack"
    if "stem_fwd_kernel<" in name:
        return "stem.cu stem forward (B2's stem)"
    if "conv3x3_tma_kernel<" in name:
        # csrc/flatconv.cu's Hopper path <TN, R, epilogue>: 2 is dz's mask
        epi = int(name.split("conv3x3_tma_kernel<")[1].split(">")[0].split(",")[2])
        return ("flatconv dz, trunk (B3)" if epi == 2
                else "flatconv forward after the stem (B2)")
    if "conv3x3_kernel<" in name:
        # csrc/flatconv.cu's template <TN, TC, epilogue, extra>
        args = name.split("conv3x3_kernel<")[1].split(">")[0].split(",")
        epi, tc = int(args[2]), int(args[1])
        return {0: "flatconv forward (B2)", 1: "flatconv side forward (B5)"}.get(
            epi, "flatconv dz, side (B6)" if tc == 16 else "flatconv dz, trunk (B3)")
    if "stem_wgrad_" in name:
        return "stem_wgrad.cu stem dK + db (B16)"
    if any(k in name for k in ("wgrad_tma_kernel", "wgrad_tma_reduce_kernel",
                               "wgrad_partial_kernel", "wgrad_reduce_kernel")):
        return "wgrad.cu dK (fast: B17; flat: B4, the dK + db of B3, and B6's dK)"
    if "::stats_" in name or "::grad_kernel<" in name:
        return "cbbce kernels (B13, B14)"
    if any(k in name for k in ("xmma", "cudnn", "gemm", "cutlass", "sm90_",
                               "nchwToNhwc", "nhwcToNchw")):
        return "cuDNN and cuBLAS (conv forward, conv dx, matmuls)"
    if "pool_fwd_kernel<" in name or "pool_bwd_kernel<" in name:
        return "pool.cu max pool forward and backward (B7-B10)"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy and memset"
    return "other PyTorch kernels (bias, ReLU, casts, loss, SGD)"
