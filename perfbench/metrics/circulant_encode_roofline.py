"""circulant_encode_roofline: the encode kernel's share of its roofline
over the window's puts: the bytes the puts' stripes need (n data blocks
in, n redundancy blocks out, int32 symbols) over the card's peak memory
rate, divided by the kernel's device time in the trace."""
from perfbench import profile_reduce, roofline


def read(rec):
    if rec.trace is None or not rec.put_stripes:
        return None
    t = profile_reduce.seconds_where(rec.trace["by_name"],
                                     "circulant_encode")
    c = rec.code
    nbytes, ops = roofline.encode_work(c["n"], c["k"], c["S"],
                                       rec.put_stripes)
    return roofline.roofline_pct(nbytes, ops, t, rec.card)
