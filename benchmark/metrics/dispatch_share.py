"""lane packing + copies: the share of the window in the lane packing,
the device dispatch and the copies back (self time of the dense-stage
entry points and the ``ops/*_dense.py`` wrappers; it includes waiting
for the device)."""

WRAPS = ["symphonia_tpu_torch.batch:FlacBatchDecoder._decode_packed_chunked",
         "symphonia_tpu_torch.ops.flac_dense:decode_packed",
         "symphonia_tpu_torch.ops.flac_dense:lpc_reconstruct_batch",
         "symphonia_tpu_torch.ops.flac_dense:lane_order",
         "symphonia_tpu_torch.ops.flac_dense:decorrelate_batch",
         "symphonia_tpu_torch.ops.aac_dense:AacDense.decode_lanes",
         "symphonia_tpu_torch.ops.aac_dense:AacDense._decode_span",
         "symphonia_tpu_torch.ops.aac_dense:aac_imdct",
         "symphonia_tpu_torch.ops.aac_dense:aac_ola"]


def read(ctx):
    return ctx.share(WRAPS)
