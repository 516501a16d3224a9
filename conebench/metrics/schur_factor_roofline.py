"""The Schur complement's Cholesky factor's share of its roofline:
work/schur_factor.py's least work over pars.profile's chol_ms (the dense
engine; the profiled phase's dtype)."""

from conebench.record import ITEMSIZE, roofline_pct
from conebench.work import schur_factor


def read(record: dict) -> float | None:
    prof = record["profile"]
    if prof is None or "chol_ms" not in prof["ms"]:
        return None
    flops, nbytes = schur_factor.count(prof["shapes"],
                                       ITEMSIZE[prof["dtype"]])
    return roofline_pct(flops, nbytes, prof["ms"]["chol_ms"], prof["dtype"],
                        record["peaks"])
