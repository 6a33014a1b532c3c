"""symphonia_tpu_torch.ops — dense decode stages, each a kernel wrapper with
a plain PyTorch twin beside it.

* ``flac_dense`` — FLAC predictor reconstruction + wasted bits (kernel F1)
  and stereo decorrelation (kernel F2).
* ``mp3_dense`` — MP3 Layer III hybrid synthesis (kernel M1), and the fp32
  polyphase product fused with the synthesis overlap-add (kernel M2), for
  Layer I/II frames too (kernel L1, M2's body).
* ``aac_dense`` — AAC-LC IMDCTs in fp32 with the handoff dequantization as
  their prologue (kernel A1), that dequantization alone (A2), and the
  window/overlap-add over many sequences in one launch (A3).
* ``vorbis_dense`` — Vorbis IMDCTs in fp32, one per block size (kernel V1,
  A1's GEMM tile), and the equal-size lap of the combined decode step
  (kernel V2).
* ``_build`` — nvcc build, ctypes loading and launch counts.

Host-only modules, numpy: ``imdct_host`` (the per-packet decoders' fast
IMDCT) and ``pcm`` (PCM bytes -> samples), copies of the reference's.
"""
