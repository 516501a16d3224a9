"""The NT scaling of one IPM step over the PSD blocks: per block of order
d an eigendecomposition with vectors (9 d^3, LAPACK's estimate), a
Cholesky factor (d^3 / 3) and two congruences (2 d^3); x's and z's blocks
read once and the scaling's block written once.  LP and SOC cones add
O(n) and are left out."""


def count(shapes: dict, itemsize: int) -> tuple[float, float]:
    flops = sum((9.0 + 1.0 / 3.0 + 2.0) * float(d) ** 3
                for d in shapes["s"])
    nbytes = sum(3.0 * float(d) ** 2 for d in shapes["s"]) * itemsize
    return flops, nbytes
