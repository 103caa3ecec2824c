"""Criteo Terabyte per-field cardinalities (MLPerf DLRM reference list)."""

# 26 categorical fields, Criteo 1TB (MLPerf reference preprocessing)
CRITEO_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)
N_DENSE = 13


def smoke_vocabs(n: int = 26, base: int = 1000):
    """Reduced-cardinality sibling for CPU smoke tests (same field count)."""
    return tuple(base + 37 * i for i in range(n))
