"""gf_matmul_roofline.decode: the GF matmul kernel's share of its
roofline in degraded reads: the bytes the decodes of the window need
(2k downloaded blocks in per degraded stripe of each key a pump served,
one block out per missing data block, int32 symbols) over the card's
peak memory rate, divided by the kernel's device time.  Nothing is read
where the window also regenerated shares."""
from perfbench import profile_reduce, roofline


def read(rec):
    if rec.trace is None or not rec.decode_stripes or rec.rebuilt_shares:
        return None
    t = profile_reduce.seconds_where(rec.trace["by_name"], "gf_matmul")
    c = rec.code
    nbytes, ops = roofline.decode_work(c["k"], c["S"], rec.decode_stripes,
                                       rec.decode_blocks)
    return roofline.roofline_pct(nbytes, ops, t, rec.card)
