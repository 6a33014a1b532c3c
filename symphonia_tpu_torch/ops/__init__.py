"""symphonia_tpu_torch.ops — dense decode stages, each a kernel wrapper with
a plain PyTorch twin beside it.

* ``flac_dense`` — FLAC predictor reconstruction + wasted bits (kernel F1)
  and stereo decorrelation (kernel F2).
* ``mp3_entropy`` — MPEG audio Layer III entropy decode of whole clips
  from their frame bytes, one thread a frame, bit-equal to the native
  library (kernel M0 ``mp3_entropy``), with the host planning of its
  frame and clip tables.
* ``mp3_dense`` — MP3 Layer III hybrid synthesis (kernel M1: a warp takes
  a run of granules, a lane one subband, the 36 x 18 product blocked in
  registers and the overlap tail carried in them), and the fp32
  polyphase synthesis in factored form (matrixing, then the 16-tap
  windowed FIR) fused with the synthesis overlap-add (kernel M2), for
  Layer I/II frames too (kernel L1, M2's body).
* ``aac_dense`` — AAC-LC IMDCTs in fp32 with the handoff dequantization as
  their prologue (kernel A1: half of the product on a pipelined SIMT tile,
  the other half mirrored in its epilogue), that dequantization alone
  (A2), and the window/overlap-add over many sequences in one launch (A3:
  a block a lane, four samples a thread as 16-byte words).
* ``vorbis_dense`` — Vorbis IMDCTs in fp32, one per block size (kernel V1,
  A1's tile and mirrored epilogue), and the equal-size lap of the combined
  decode step (kernel V2).
* ``pcm`` — PCM bytes -> samples: the numpy oracle ``decode_pcm_np`` of the
  per-packet decoders, and the batch unpack of padded packets for 18
  codecs (kernel P1 ``pcm_unpack``, behind ``decode_pcm_batch``).
* ``rice_device`` — FLAC Rice residual decode over independent lane
  cursors (kernel R1 ``rice_decode``, behind ``rice_decode_lanes``).
* ``_build`` — nvcc build, ctypes loading and launch counts.

Host-only module, numpy: ``imdct_host`` (the per-packet decoders' fast
IMDCT), a copy of the reference's.
"""
