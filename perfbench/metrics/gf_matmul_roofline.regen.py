"""gf_matmul_roofline.regen: the GF matmul kernel's share of its
roofline in regeneration: the bytes the shares rebuilt in the window
need (d = k+1 helper blocks in, 2 blocks out a share, int32 symbols)
over the card's peak memory rate, divided by the kernel's device time.
Nothing is read where the window also decoded, since the trace does
not tell the two uses of the kernel apart."""
from perfbench import profile_reduce, roofline


def read(rec):
    if rec.trace is None or not rec.rebuilt_shares or rec.decode_stripes \
            or rec.drain.get("decode_calls"):
        return None
    t = profile_reduce.seconds_where(rec.trace["by_name"], "gf_matmul")
    c = rec.code
    nbytes, ops = roofline.regen_work(c["k"], c["S"], rec.rebuilt_shares)
    return roofline.roofline_pct(nbytes, ops, t, rec.card)
