"""gf_matmul_roofline.regen: the GF matmul kernel's share of its
roofline in regeneration: the bytes the shares rebuilt in the window
need (double-circulant: d = k+1 helper blocks in, 2 blocks out a share;
product-matrix: its helper sends and newcomer products; int32 symbols,
``roofline.regen_work_of``) over the card's peak memory rate, divided
by the kernel's device time.
Nothing is read where the window also decoded, since the trace does
not tell the two uses of the kernel apart."""
from perfbench import profile_reduce, roofline


def read(rec):
    if rec.trace is None or not rec.rebuilt_shares or rec.decode_stripes \
            or rec.drain.get("decode_calls"):
        return None
    t = profile_reduce.seconds_where(rec.trace["by_name"], "gf_matmul")
    nbytes, ops = roofline.regen_work_of(rec.code, rec.rebuilt_shares)
    return roofline.roofline_pct(nbytes, ops, t, rec.card)
