"""symphonia_tpu_torch.ops — dense decode stages, each a kernel wrapper with
a plain PyTorch twin beside it.

* ``flac_dense`` — FLAC predictor reconstruction + wasted bits (kernel F1)
  and stereo decorrelation (kernel F2).
* ``mp3_dense`` — MP3 Layer III hybrid synthesis (kernel M1), and the fp32
  polyphase product fused with the synthesis overlap-add (kernel M2).
* ``_build`` — nvcc build, ctypes loading and launch counts.
"""
