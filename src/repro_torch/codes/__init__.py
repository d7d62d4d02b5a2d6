"""Pluggable code-family subsystem of the port (DESIGN.md §15): the abstract
:class:`ErasureCode` interface, the serializable :class:`CodeClass`
descriptor, and the family registry mapping descriptors to live codes.
"""
from .base import (CodeClass, CodeRepairPlan, ErasureCode,
                   generic_share_crc, is_one_hot)
from .registry import (FAMILY_DOUBLE_CIRCULANT, FAMILY_PRODUCT_MATRIX,
                       default_code_class, families, make_code,
                       register_family)

__all__ = [
    "CodeClass", "CodeRepairPlan", "ErasureCode", "generic_share_crc",
    "is_one_hot", "FAMILY_DOUBLE_CIRCULANT", "FAMILY_PRODUCT_MATRIX",
    "default_code_class", "families", "make_code", "register_family",
]
