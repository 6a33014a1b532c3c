"""AAC's kernel work: A1 (the IMDCT, half the product computed and the
rest mirrored; long lanes with the dequantisation prologue, short lanes
as eight 128-point windows) and A3 (window and overlap-add)."""

from . import bound_s


def work_aac_imdct(L: int, n: int, prologue: bool):
    """``chip_smoke.work_aac_imdct`` (half product): (bytes, macs)."""
    nbytes = L * n * 4 + n * n * 4 + L * 2 * n * 4
    if prologue:
        nbytes += L * n * 2 + L * 64 * 4 + L * 4 + (1024 + 8192) * 4
    return nbytes, float(L) * n * n


def work_aac_ola(L: int):
    return L * 2048 * 4 + L * 1024 * 4 + L * 13 + 2 * 4 * 2 * 1024 * 4, 0.0


def least_s(pool, idx) -> float:
    """Least seconds of the kernel work of one request over pool[idx]:
    every (frame, channel) is a lane."""
    short = sum(int((pool[i].seqs == 2).sum()) * pool[i].quant.shape[1]
                for i in idx)
    lanes = sum(pool[i].quant.shape[0] * pool[i].quant.shape[1] for i in idx)
    return (bound_s(*work_aac_imdct(lanes - short, 1024, True))
            + bound_s(*work_aac_imdct(8 * short, 128, False))
            + bound_s(*work_aac_ola(lanes)))
