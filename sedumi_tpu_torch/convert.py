"""Carry state across from the reference package's arrays (as numpy).

The step-parity tests drive both packages from the same iterate: the
reference's IPMState / CooAOp leaves, turned into numpy arrays by the
caller, become the port's tensors here.  Nothing here imports the
reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from .cones import Layout
from .ipm import IPMState
from .opA import CooAOp
from .structs import F64, ConeVec


def _t(a, device, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def conevec_from_numpy(layout: Layout, l, q, s, device="cuda") -> ConeVec:
    """A ConeVec from per-bucket arrays (l [nl], q per q-bucket
    [count, d], s per s-bucket [count, d, d])."""
    if len(q) != len(layout.q_buckets) or len(s) != len(layout.s_buckets):
        raise ValueError("bucket counts do not match the layout")
    return ConeVec(l=_t(l, device), q=tuple(_t(a, device) for a in q),
                   s=tuple(_t(a, device) for a in s))


def state_from_numpy(layout: Layout, x, y, z, tau, kappa,
                     device="cuda") -> IPMState:
    """The port's IPMState from the reference's iterate; x and z are
    (l, q, s) triples of arrays as conevec_from_numpy takes them."""
    return IPMState(x=conevec_from_numpy(layout, *x, device=device),
                    y=_t(y, device),
                    z=conevec_from_numpy(layout, *z, device=device),
                    tau=_t(tau, device).reshape(()),
                    kappa=_t(kappa, device).reshape(()))


def state_to_numpy(state: IPMState):
    """(x, y, z, tau, kappa) as numpy, x and z as (l, q, s) triples."""
    def cv(v: ConeVec):
        return (v.l.cpu().numpy(), [a.cpu().numpy() for a in v.q],
                [a.cpu().numpy() for a in v.s])

    return (cv(state.x), state.y.cpu().numpy(), cv(state.z),
            float(state.tau), float(state.kappa))


def aop_from_numpy(Al, Aq, s_parts, q_shapes, s_meta,
                   device="cuda") -> CooAOp:
    """The port's CooAOp from the reference CooAOp's arrays: Al, Aq list,
    s_parts (list of dicts of arrays with the reference's keys), q_shapes
    and s_meta.  The CSR row pointer the port's Schur gather needs is
    derived from the sorted b_row."""
    parts = []
    for part, meta in zip(s_parts, s_meta):
        out = {}
        for key, a in part.items():
            a = np.asarray(a)
            out[key] = _t(a, device, F64 if a.dtype.kind == "f"
                          else torch.int64)
        if meta[0] == "coo":
            mp1 = np.asarray(Al).shape[0]
            out["b_rowptr"] = _t(np.searchsorted(np.asarray(part["b_row"]),
                                                 np.arange(mp1 + 1)),
                                 device, torch.int64)
        parts.append(out)
    return CooAOp(Al=_t(Al, device), Aq=[_t(a, device) for a in Aq],
                  s_parts=parts, q_shapes=q_shapes, s_meta=s_meta)
