"""host entropy: the share of the window in the batch decoders' host
stage (native extraction through ``native.py``; AAC's includes its
re-probe, demux and packet loop), by self time."""

WRAPS = ["symphonia_tpu_torch.batch:FlacBatchDecoder._extract_host",
         "symphonia_tpu_torch.batch:AacBatchDecoder._extract_host"]


def read(ctx):
    return ctx.share(WRAPS)
