"""Precision regime of the port: native f64 only.

The H100 computes f64 natively, so the port runs the solver in the f64
mode that the reference runs on a CPU, with its dd64 endgame rung
(solver.py).  The f32 -> hybrid -> host64 ladder of the reference (its
fp.precision_mode 'mixed'/'f32') exists for accelerators without f64 and
is not ported yet: asking for it raises.

The Veltkamp splitting constant for the error-free TwoProd (pcg.two_prod,
which ddlinalg shares) is 2^ceil(53/2)+1 for f64.
"""

from __future__ import annotations

_SPLIT_F64 = 134217729.0     # 2^27 + 1, p = 53

_NOT_PORTED = ("pars.dtype={!r}: the mixed/f32 precision ladder is not "
               "ported yet (ROADMAP queue A item 9); use 'auto' or "
               "'float64'")


def precision_mode(requested: str | None = "auto") -> str:
    """The precision regime the solver runs in: always 'f64' here."""
    if requested in (None, "auto", "float64", "f64"):
        return "f64"
    raise NotImplementedError(_NOT_PORTED.format(requested))


def split_const() -> float:
    """Veltkamp constant of f64 (the only dtype the port computes in)."""
    return _SPLIT_F64

