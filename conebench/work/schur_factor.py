"""The Cholesky factor of the m x m Schur complement: m^3 / 3 flops, its
lower triangle read once and the factor's triangle written once."""


def count(shapes: dict, itemsize: int) -> tuple[float, float]:
    m = float(shapes["m"])
    return m ** 3 / 3.0, m * (m + 1.0) * itemsize
