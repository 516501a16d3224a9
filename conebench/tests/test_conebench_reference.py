"""The plain reference judges a right answer as right and a perturbed one
as wrong, on a tiny instance solved in closed form."""

from __future__ import annotations

import numpy as np
import pytest

from conebench.certify import judge
from conebench.instance import Instance
from conebench.reference import certificate


def _two_by_two():
    """min -<[[0, 1], [1, 0]], X> s.t. diag(X) = 1, X psd: X = ones,
    y = [-1, -1], optimum -2 (max-cut of one edge of weight 2)."""
    c = -np.array([0.0, 1.0, 1.0, 0.0])
    At = np.zeros((4, 2))
    At[0, 0] = At[3, 1] = 1.0
    import scipy.sparse as sp

    inst = Instance(At=sp.csc_matrix(At), b=np.ones(2), c=c, K={"s": [2]},
                    shapes={"m": 2, "l": 0, "q": [], "s": [2]})
    return inst, np.ones(4), np.array([-1.0, -1.0])


def test_known_answer_is_exact():
    inst, x, y = _two_by_two()
    errs = certificate.dimacs(inst.At, inst.b, inst.c, inst.K, x, y)
    assert certificate.worst(errs) == 0.0
    assert errs["cx"] == -2.0 and errs["by"] == -2.0


@pytest.mark.parametrize("which, key", [
    ("x_off_diag", "p_cone"), ("x_diag", "p_res"), ("y", "d_cone"),
    ("y_up", "gap")])
def test_perturbed_answer_reads_wrong(which, key):
    inst, x, y = _two_by_two()
    x, y = x.copy(), y.copy()
    if which == "x_off_diag":
        x[[1, 2]] += 1e-4       # |X_12| > 1: X leaves the cone
    elif which == "x_diag":
        x[0] += 1e-4            # diag(X) = 1 broken
    elif which == "y":
        y[0] += 1e-4            # C - Diag(y) leaves the cone
    else:
        y -= 1e-4               # dual feasible, but a gap opens
    errs = certificate.dimacs(inst.At, inst.b, inst.c, inst.K, x, y)
    assert errs[key] > 1e-5
    assert certificate.worst(errs) > 1e-5


def test_lp_and_soc_cones():
    K = {"l": 2, "q": [3], "s": [2]}
    v = np.array([1.0, 2.0, 2.0, 1.0, 1.0, 1.0, 0.0, 0.0, 1.0])
    assert np.isclose(certificate.cone_min(v, K), min(1.0, 2.0 - np.sqrt(2),
                                                      1.0))
    with pytest.raises(ValueError):
        certificate.cone_min(v[:-1], K)


def test_judge_reads_what_the_program_said():
    inst, x, y = _two_by_two()
    good = judge({"inst": inst, "x": x, "y": y,
                  "info": {"numerr": 0, "pinf": 0, "dinf": 0}})
    assert good == {"no_answer": 0, "worst_err": 0.0, "numerr": 0,
                    "infeasible": 0}
    bad = judge({"inst": inst, "x": x * np.nan, "y": y,
                 "info": {"numerr": 1, "pinf": 1, "dinf": 0}})
    assert bad["worst_err"] == float("inf") and bad["numerr"] == 1 \
        and bad["infeasible"] == 1
    assert judge({"inst": inst, "error": "boom"})["no_answer"] == 1
