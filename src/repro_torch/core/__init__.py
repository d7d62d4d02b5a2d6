"""Core of the port: GF(p) arithmetic, the double-circulant construction,
the fused repair engine and the MSR code (Gastón & Pujol 2010), rack-aware
placement and the baselines the paper compares against."""
from . import gf, circulant, msr, repair, placement, baselines  # noqa: F401
from .circulant import CodeSpec, check_condition6, find_coefficients, min_field_size  # noqa: F401
from .msr import DoubleCirculantMSR, RepairPlan, encode_file, reconstruct_file, shares_from_numpy  # noqa: F401
from .repair import DecodeInverseCache, RepairEngine, build_repair_matrix  # noqa: F401
