"""The NT scaling's share of its roofline: work/nt_scaling.py's least
work over pars.profile's nt_scaling_ms (the profiled phase's dtype)."""

from conebench.record import ITEMSIZE, roofline_pct
from conebench.work import nt_scaling


def read(record: dict) -> float | None:
    prof = record["profile"]
    if prof is None or "nt_scaling_ms" not in prof["ms"] \
            or not prof["shapes"]["s"]:
        return None
    flops, nbytes = nt_scaling.count(prof["shapes"], ITEMSIZE[prof["dtype"]])
    return roofline_pct(flops, nbytes, prof["ms"]["nt_scaling_ms"],
                        prof["dtype"], record["peaks"])
