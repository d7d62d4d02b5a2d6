"""The yardstick for the kernels: published peaks of the card and the
bytes and operations each kernel's work needs.

Work is counted from what the traffic required, never from the launches
an implementation made: each input symbol read once and each output
symbol written once, at the bytes a symbol takes in the launches'
operands (int32, 4 bytes).  The small coefficient and repair matrices
are left out (under 0.01% of any count here).  A share of the roofline
is the least time the card could take for that work, bytes over the
peak memory rate or operations over the peak integer rate, whichever is
larger, divided by the kernel's measured device time.
"""
from __future__ import annotations

SYMBOL_BYTES = 4

# Published peak memory rates (NVIDIA data sheets), by card name; the
# first whose tag is in the name applies.
MEM_PEAK = (("H100 PCIe", 2.0e12, "H100 PCIe data sheet 2.0 TB/s"),
            ("H100 NVL", 3.9e12, "H100 NVL data sheet 3.9 TB/s"),
            ("H100", 3.35e12, "H100 SXM data sheet 3.35 TB/s"))
# Integer lanes run on the CUDA cores; the data sheet's float32 rate
# outside the tensor cores bounds them from above.
OPS_PEAK = (67e12, "H100 SXM float32 non-tensor 67 TFLOP/s")


def mem_peak(card: str) -> float | None:
    """Peak memory rate in bytes/s of a card by name, None if unknown."""
    for tag, rate, _src in MEM_PEAK:
        if tag in card:
            return rate
    return None


def encode_work(n: int, k: int, s: int, stripes: int) -> tuple[int, int]:
    """(bytes, operations) of encoding ``stripes`` stripes: n data blocks
    in, n redundancy blocks out, k multiply-adds per output symbol."""
    sym = n * s * stripes
    return 2 * sym * SYMBOL_BYTES, 2 * k * sym


def regen_work(k: int, s: int, shares: int) -> tuple[int, int]:
    """(bytes, operations) of regenerating ``shares`` lost shares: d =
    k + 1 helper blocks in, the two blocks of the share out, d
    multiply-adds per output symbol."""
    return (k + 3) * s * shares * SYMBOL_BYTES, 2 * 2 * (k + 1) * s * shares


def pm_regen_work(d: int, alpha: int, s: int, shares: int,
                  ) -> tuple[int, int]:
    """(bytes, operations) of regenerating ``shares`` lost shares of the
    product-matrix code, in its two launches: the helper sends (d
    helpers, each alpha blocks in and one send out, alpha multiply-adds
    a symbol) and the newcomer product (d sends in, the alpha blocks of
    the share out, d multiply-adds a symbol): (d alpha + 2d + alpha)
    blocks and 2 alpha d multiply-adds a symbol column."""
    return ((d * alpha + 2 * d + alpha) * s * shares * SYMBOL_BYTES,
            2 * 2 * alpha * d * s * shares)


def regen_work_of(code: dict, shares: int) -> tuple[int, int]:
    """The regeneration work of a run's code (``Record.code``), by
    family."""
    if code["family"] == "double-circulant":
        return regen_work(code["k"], code["S"], shares)
    return pm_regen_work(code["d"], code["share_blocks"], code["S"], shares)


def decode_work(k: int, s: int, stripes: int, missing: int,
                ) -> tuple[int, int]:
    """(bytes, operations) of decoding ``missing`` data blocks out of
    ``stripes`` degraded stripes: 2k downloaded blocks in per stripe,
    one block out per missing block, 2k multiply-adds per output
    symbol."""
    return ((2 * k * stripes + missing) * s * SYMBOL_BYTES,
            2 * 2 * k * missing * s)


def roofline_pct(nbytes: float, ops: float, kernel_s: float,
                 card: str) -> float | None:
    """The kernel's share of its roofline in percent, or None when the
    card's peak is unknown or nothing ran."""
    rate = mem_peak(card)
    if rate is None or kernel_s <= 0 or nbytes <= 0:
        return None
    least_s = max(nbytes / rate, ops / OPS_PEAK[0])
    return 100.0 * least_s / kernel_s


__all__ = ["SYMBOL_BYTES", "MEM_PEAK", "OPS_PEAK", "mem_peak",
           "encode_work", "regen_work", "pm_regen_work", "regen_work_of",
           "decode_work", "roofline_pct"]
