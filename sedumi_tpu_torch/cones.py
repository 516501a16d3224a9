"""Cone specifications and the internal bucketed layout.

Two views of a cone product:

* :class:`ConeSpec` — the user-facing ``K`` struct (reference: sedumi.m:49-92):
  free vars ``f``, nonnegative orthant ``l``, Lorentz cones ``q``, rotated
  Lorentz cones ``r``, PSD cones ``s`` with ``scomplex`` marking Hermitian
  blocks, plus ``xcomplex``/``ycomplex`` for complex data.

* :class:`Layout` — the internal canonical form after transformation
  (reference analog: the K fields emitted by pretransfo.m:524-542).  Only
  ``l``/``q``/``s`` survive; all data is real (Hermitian blocks are
  real-embedded by the transform).  TPU-first design decision: cone blocks
  of identical dimension are grouped into *buckets* so every Jordan-algebra
  kernel runs as one batched dense op per bucket (replacing the reference's
  per-block MATLAB loops, e.g. psdeig.m:59, psdscale.m:76).  The flat
  internal vector layout is ``[lp | q-block-0 .. | vec(S-block-0) .. ]``
  with PSD blocks stored as full (symmetrized) s*s vecs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np


def _as_int_tuple(v: Any) -> tuple[int, ...]:
    if v is None:
        return ()
    arr = np.asarray(v).ravel()
    out = tuple(int(x) for x in arr if int(x) > 0)
    return out


@dataclass(frozen=True)
class ConeSpec:
    """User-facing cone product K (validated; see sedumi.m:49-92).

    Fields:
      f -- number of free (unrestricted) leading variables.
      l -- dimension of the nonnegative orthant.
      q -- Lorentz cone dims (each >= 1): x1 >= ||x[2:]||.
      r -- rotated Lorentz cone dims (each >= 2): 2*x1*x2 >= ||x[3:]||^2.
      s -- PSD block orders.
      scomplex -- 1-based indices into s of complex-Hermitian blocks
                  (reference merges K.z into scomplex, pretransfo.m:146-154).
      xcomplex -- 1-based indices of complex entries among the f/q/r vars.
      ycomplex -- 1-based indices of constraints with complex data.
    """

    f: int = 0
    l: int = 0
    q: tuple[int, ...] = ()
    r: tuple[int, ...] = ()
    s: tuple[int, ...] = ()
    scomplex: tuple[int, ...] = ()
    xcomplex: tuple[int, ...] = ()
    ycomplex: tuple[int, ...] = ()

    @classmethod
    def make(cls, K: "ConeSpec | Mapping[str, Any] | None") -> "ConeSpec":
        """Normalize a user K (dict, matlab struct-array, or ConeSpec)."""
        if K is None:
            return cls()
        if isinstance(K, cls):
            return K
        d: dict[str, Any] = {}
        if hasattr(K, "dtype") and getattr(K, "dtype", None) is not None and K.dtype.names:
            # scipy.io.loadmat struct array
            for name in K.dtype.names:
                d[name] = np.asarray(K[name][0, 0]).ravel()
        else:
            d = dict(K)
        f = int(np.sum(np.asarray(d.get("f", 0)))) if "f" in d else 0
        l = int(np.sum(np.asarray(d.get("l", 0)))) if "l" in d else 0
        q = _as_int_tuple(d.get("q"))
        r = _as_int_tuple(d.get("r"))
        s = _as_int_tuple(d.get("s"))
        # K.z is a legacy alias: z[i]=1 marks s-block i as Hermitian
        # (pretransfo.m:146-154).  Merge into scomplex.
        scomplex = set(int(i) for i in np.asarray(d.get("scomplex", ()), dtype=object).ravel() if str(i).strip())
        if "z" in d:
            zmask = np.asarray(d["z"]).ravel()
            scomplex |= {i + 1 for i, zi in enumerate(zmask) if zi}
        xcomplex = tuple(int(i) for i in np.asarray(d.get("xcomplex", ())).ravel())
        ycomplex = tuple(int(i) for i in np.asarray(d.get("ycomplex", ())).ravel())
        for qi in q:
            if qi < 1:
                raise ValueError(f"Lorentz cone dim must be >= 1, got {qi}")
        for ri in r:
            if ri < 2:
                raise ValueError(f"rotated cone dim must be >= 2, got {ri}")
        bad = [i for i in sorted(scomplex) if not (1 <= i <= len(s))]
        if bad:
            raise ValueError(f"scomplex indices out of range: {bad}")
        return cls(
            f=f, l=l, q=q, r=r, s=s,
            scomplex=tuple(sorted(scomplex)),
            xcomplex=xcomplex, ycomplex=ycomplex,
        )

    @property
    def dim(self) -> int:
        """Total length of the user-facing x vector (full PSD vecs)."""
        return self.f + self.l + sum(self.q) + sum(self.r) + sum(si * si for si in self.s)


@dataclass(frozen=True)
class Bucket:
    """A group of same-dimension cone blocks, batched on device.

    ``block_ids`` are indices into the layout's q (or s) tuple, in layout
    order; ``dim`` is the common block dimension.  ``herm`` marks buckets
    of real-EMBEDDED complex-Hermitian blocks (dim = 2*d of the complex
    block): grouped separately so the NT scaling can run the native
    complex eigensolver on them (lax_eigh.jacobi_eigh_herm — half the
    rotation rounds of the embedding; reference psdeig.m:64-67).
    """

    dim: int
    block_ids: tuple[int, ...]
    herm: bool = False

    @property
    def count(self) -> int:
        return len(self.block_ids)


def pack_plan(dims: Sequence[int], cap: int) -> list[list[int]]:
    """First-fit-decreasing packing of PSD blocks into superblocks.

    TPU-first design: a PSD block of order d occupies (ceil(d/8) x
    ceil(d/128)) hardware tiles regardless of d, so order-6 blocks waste
    >100x memory and VPU lanes.  Packing small blocks into a block-diagonal
    superblock of order <= cap is *exact*: the problem data never couples
    sub-blocks, so the dual slack stays block-diagonal, the central path of
    the packed problem coincides with the original's (X = mu Z^{-1} with
    block-diagonal Z), and every Jordan/spectral kernel is invariant.
    Blocks of order >= cap stay alone.  Returns lists of block indices;
    each list is one internal superblock (order = sum of member orders).
    """
    order = sorted(range(len(dims)), key=lambda i: (-dims[i], i))
    bins: list[tuple[int, list[int]]] = []   # (used, ids)
    out_singletons: list[list[int]] = []
    for i in order:
        d = dims[i]
        if d >= cap:
            out_singletons.append([i])
            continue
        for k, (used, ids) in enumerate(bins):
            if used + d <= cap:
                bins[k] = (used + d, ids + [i])
                break
        else:
            bins.append((d, [i]))
    groups = out_singletons + [ids for _, ids in bins]
    # deterministic order: by first member's original position
    groups.sort(key=lambda ids: min(ids))
    return groups


def _make_buckets(dims: Sequence[int], herm: Sequence[bool] | None = None
                  ) -> tuple[Bucket, ...]:
    groups: dict[tuple[int, bool], list[int]] = {}
    for i, d in enumerate(dims):
        h = bool(herm[i]) if herm else False
        groups.setdefault((d, h), []).append(i)
    return tuple(Bucket(dim=d, block_ids=tuple(ids), herm=h)
                 for (d, h), ids in sorted(groups.items()))


@dataclass(frozen=True)
class Layout:
    """Internal canonical cone layout (all-real l/q/s product).

    Derived static metadata used by every device kernel; built once per
    problem on the host (reference analog: pretransfo.m:524-542 emits
    blkstart/mainblks/qblkstart/sblkstart/lq/N).
    """

    l: int
    q: tuple[int, ...]
    s: tuple[int, ...]
    s_herm: tuple[bool, ...] = ()   # per-s-block: real-embedded Hermitian
    q_buckets: tuple[Bucket, ...] = field(init=False)
    s_buckets: tuple[Bucket, ...] = field(init=False)

    def __post_init__(self) -> None:
        sh = tuple(self.s_herm) if len(self.s_herm) == len(self.s) \
            else (False,) * len(self.s)
        object.__setattr__(self, "s_herm", sh)
        object.__setattr__(self, "q_buckets", _make_buckets(self.q))
        object.__setattr__(self, "s_buckets", _make_buckets(self.s, sh))

    # --- flat-vector offsets -------------------------------------------------
    @property
    def q_start(self) -> int:
        return self.l

    @property
    def s_start(self) -> int:
        return self.l + sum(self.q)

    @property
    def N(self) -> int:
        """Flat internal vector length (PSD blocks as full s^2 vecs)."""
        return self.l + sum(self.q) + sum(si * si for si in self.s)

    @property
    def nu(self) -> float:
        """Barrier rank of K: l + 2*(#Lorentz) + sum(s)."""
        return float(self.l + 2 * len(self.q) + sum(self.s))

    def q_offsets(self) -> np.ndarray:
        """Start offset of each Lorentz block in the flat vector."""
        return self.q_start + np.concatenate([[0], np.cumsum(self.q)[:-1]]).astype(np.int64) \
            if self.q else np.zeros(0, np.int64)

    def s_offsets(self) -> np.ndarray:
        """Start offset of each PSD block (s^2 entries) in the flat vector."""
        sizes = np.array([si * si for si in self.s], np.int64)
        return self.s_start + np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64) \
            if self.s else np.zeros(0, np.int64)

    @property
    def num_eigs(self) -> int:
        """Total number of spectral values of an element of K."""
        return self.l + 2 * len(self.q) + sum(self.s)
