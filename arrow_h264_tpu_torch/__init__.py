"""PyTorch/CUDA port of the arrow_h264_tpu decoder.

The host half (bitstream, entropy, DPB bookkeeping, frame ABI packing) is
imported from `arrow_h264_tpu`, whose host modules import no JAX.  The
device half (residual, motion compensation, intra, deblock, reference
store) is PyTorch here, with hand-written CUDA kernels for the four stages
that were Pallas kernels in the JAX package (`ops/kernels`, `csrc/`).

    from arrow_h264_tpu_torch.api import Decoder
    for frame in Decoder(device="cuda").decode_annexb(data):
        frame.y, frame.cb, frame.cr
"""
