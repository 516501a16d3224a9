"""Carry state across from the reference package's arrays (as numpy).

The parity tests drive both packages from the same inputs: the
reference's IPMState / CooAOp / Scaling leaves, turned into numpy arrays
by the caller, become the port's tensors here.  Nothing here imports the
reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from .cones import Layout
from .ipm import IPMState
from .nt import Scaling
from .opA import CooAOp, DenseAOp, needed_entries
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


def scaling_from_numpy(S, device="cuda") -> Scaling:
    """The port's nt.Scaling from the reference's: S has Scaling's fields,
    d_l and lam_l as arrays and the others as sequences of per-bucket
    arrays (the reference's Scaling with its leaves turned into numpy)."""
    vals = {}
    for name in Scaling._fields:
        v = getattr(S, name)
        vals[name] = _t(v, device) if name in ("d_l", "lam_l") \
            else tuple(_t(a, device) for a in v)
    return Scaling(**vals)


def aop_from_numpy(Al, Aq, s_parts, q_shapes, s_meta,
                   device="cuda") -> CooAOp:
    """The port's CooAOp from the reference CooAOp's arrays: Al, Aq list,
    s_parts (list of dicts of arrays with the reference's keys), q_shapes
    and s_meta.  The CSR row pointer the port's Schur gather needs is
    derived from the sorted b_row, the B~ slots from g_row and g_blk, and
    K2's needed-entry arrays (opA.needed_entries) from b_row and b_loc."""
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
            out["g_slot"] = out["g_row"] * meta[1] + out["g_blk"]
            for key, a in needed_entries(
                    part["b_row"], part["b_loc"],
                    np.asarray(part["g_row"]) * meta[1]
                    + np.asarray(part["g_blk"]),
                    mp1, meta[1], meta[2]).items():
                out[key] = _t(a, device, torch.int32)
        parts.append(out)
    return CooAOp(Al=_t(Al, device), Aq=[_t(a, device) for a in Aq],
                  s_parts=parts, q_shapes=q_shapes, s_meta=s_meta)


def dense_aop_from_numpy(Al, Aq, As, q_shapes, s_shapes,
                         device="cuda") -> DenseAOp:
    """The port's DenseAOp from the reference DenseAOp's arrays."""
    return DenseAOp(Al=_t(Al, device), Aq=[_t(a, device) for a in Aq],
                    As=[_t(a, device) for a in As], q_shapes=q_shapes,
                    s_shapes=s_shapes)
