"""The collectives' least time, for the dp step's all-reduce roofline.

An all-reduce of ``nbytes`` over ``ranks`` ranks has each rank receive at
least (ranks - 1) / ranks x ``nbytes``: every other rank's share of the sum
has to reach it, whether the ranks add the shares themselves (ring, tree)
or a switch adds them (NVLink SHARP). Over one card's NVLink ports that
takes at least that many bytes over ``LINK_BYTES_PER_S``.
"""

from __future__ import annotations

# One H100 SXM's NVLink 4 bandwidth in one direction (18 links x 25 GB/s;
# NVIDIA's data sheet gives 900 GB/s both ways).
LINK_BYTES_PER_S = 450e9


def allreduce_floor_s(nbytes: float, ranks: int) -> float:
    """The least time of one all-reduce of ``nbytes`` over ``ranks`` ranks."""
    return (ranks - 1) / ranks * nbytes / LINK_BYTES_PER_S
