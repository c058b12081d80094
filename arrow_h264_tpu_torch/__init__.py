"""PyTorch/CUDA port of the arrow_h264_tpu decoder.

The package stands alone: it imports torch and numpy, never jax and
nothing of `arrow_h264_tpu`.  The host half (bitstream, entropy, DPB
bookkeeping, frame ABI packing, the C++ entropy library in `host/cpp/`)
is its own copy of the JAX package's host code.  The device half
(residual, motion compensation, intra, deblock, reference store) is
PyTorch, with hand-written CUDA kernels for the stages that were Pallas
kernels in the JAX package (`ops/kernels`, `csrc/`).

    from arrow_h264_tpu_torch.api import Decoder
    for frame in Decoder(device="cuda").decode_annexb(data):
        frame.y, frame.cb, frame.cr
"""
