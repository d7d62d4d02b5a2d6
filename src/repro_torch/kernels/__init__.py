"""GF(p) compute layer of the port: the exactness envelope, the plain
torch versions, the two Hopper kernels and their dispatch registry."""

from . import dispatch, ops, ref  # noqa: F401
