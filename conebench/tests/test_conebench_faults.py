"""The harness's `correct` on the CPU at a test size: true for the
program as it is, false for the control (the program's lower precision,
pars.dtype='float32') and for each fault a cell can have, planted in the
program underneath the harness: an IPM step that returns its state
unchanged, an answer altered where it is produced, a stale answer (the
last instance's, as when half the work is skipped), and a solve that
raises.  The look for a card is skipped: the harness runs on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

import sedumi_tpu_torch
from sedumi_tpu_torch import ipm, transform
from conebench import spec
from conebench.harness import run_cell
from conebench.tests.conftest import tiny_cell

SEED = 2**31 + 4242


def _run(cell, lines, trace=False):
    return run_cell(cell, SEED, 0.5, trace, device="cpu", log=lines.append)


@pytest.mark.parametrize("name", ["arch0.f64", "control07.f64",
                                  "control07.mixed"])
def test_sound_program_is_correct(name, lines):
    res = _run(tiny_cell(name), lines)
    assert res["correct"] and res["failed"] == 0, lines[-6:]
    assert res["attempted"] >= 1
    assert list(res)[-1] == "checks" and lines[-1].startswith("check ")
    assert res["metrics"]["solve_s"]["value"] > 0


@pytest.mark.parametrize("name,held", [
    ("arch0.f64", ("arch0.f64",)),
    ("control07.f64", ("control07.f64", "control07.mixed"))])
def test_control_is_not_correct(name, held, lines):
    """The float32 control on the cell's own instance (on the tiny grid an
    f32 answer would meet the cells' limits): one seeded instance, held to
    the limits of every cell of that configuration."""
    cell = spec.cell(name)
    cell["traffic"] = {**cell["traffic"], "pool": 1,
                       "pars": {**cell["traffic"]["pars"],
                                "dtype": "float32"}}
    res = _run(cell, lines)
    assert not res["correct"]
    for other in held:
        checks = spec.cell(other)["checks"]
        assert any(res["checks"][k]["value"] > checks[k]["limit"]
                   for k in checks), other


def test_unchanged_state_is_not_correct(lines, monkeypatch):
    real = ipm.make_step

    def make_step(*args, **kw):
        step = real(*args, **kw)

        def frozen(aop, b, rs, state, reg, **kw2):
            _, stats = step(aop, b, rs, state, reg, **kw2)
            return state, stats
        return frozen

    monkeypatch.setattr(ipm, "make_step", make_step)
    cell = tiny_cell("arch0.f64", pool=1)
    cell["traffic"]["pars"] = {**cell["traffic"]["pars"], "maxiter": 30}
    res = _run(cell, lines)
    assert not res["correct"] and res["failed"] == res["attempted"]


def test_altered_answer_is_not_correct(lines, monkeypatch):
    real = transform.posttransfo_x

    def altered(prob, x_int):
        x = real(prob, x_int).copy()
        x[0] += 1.0
        return x

    monkeypatch.setattr(transform, "posttransfo_x", altered)
    res = _run(tiny_cell("control07.f64"), lines)
    assert not res["correct"]
    assert res["checks"]["worst_err"]["value"] \
        > res["checks"]["worst_err"]["limit"]


def test_stale_answer_is_not_correct(lines, monkeypatch):
    real = sedumi_tpu_torch.sedumi
    last = {}

    def stale(At, b, c, K, pars, device):
        if "answer" in last:
            return last.pop("answer")
        last["answer"] = real(At, b, c, K, pars, device=device)
        return last["answer"]

    monkeypatch.setattr(sedumi_tpu_torch, "sedumi", stale)
    cell = tiny_cell("arch0.f64", pool=2)
    res = run_cell(cell, SEED, 3.0, False, device="cpu", log=lines.append)
    assert res["attempted"] >= 2 and not res["correct"]


def test_raising_solve_is_not_correct(lines, monkeypatch):
    real = sedumi_tpu_torch.sedumi
    calls = []

    def flaky(At, b, c, K, pars, device):
        calls.append(1)
        if len(calls) == 2:      # the warm-up solve is the first call
            raise FloatingPointError("planted")
        return real(At, b, c, K, pars, device=device)

    monkeypatch.setattr(sedumi_tpu_torch, "sedumi", flaky)
    res = _run(tiny_cell("arch0.f64"), lines)
    assert not res["correct"] and res["failed"] >= 1
    assert res["checks"]["no_answer"]["value"] == 1
    assert any("planted" in line for line in lines)


def test_traced_run_on_cpu(lines):
    res = _run(tiny_cell("control07.f64", pool=1), lines, trace=True)
    assert res["correct"]
    names = set(res["metrics"])
    assert {"front_s", "post_s", "iter_ms", "iters"} <= names
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert np.isfinite(res["metrics"]["iter_ms"]["value"])
