"""Repeat some of chip_smoke.py's checks on the card, to look for one that
fails only now and then.

Each round runs, through chip_smoke.py's own functions and gates:
  - K14/K15 and K14-f32/K15-f32 at the mesh path's shapes against their
    plain versions and, bit for bit, tests/panel_emulation.py (a new seed
    each round), and K14 on grids of 1 and 3 CTAs against its default grid;
  - three arch0 f64 solves as they run, each held to DD64_LANDINGS;
  - one control07 'mixed' solve, held to MIXED_LANDINGS.
A failed gate is recorded and the rounds go on.  Rounds start until
SECONDS have passed.  The last line is a JSON summary: the rounds, the
checks, and every check that did not pass.

    python3 smoke_repeat.py [SECONDS]      (from the repository's root)
"""
import json
import os
import sys
import time
import traceback

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))   # panel_emulation

import chip_smoke as cs  # noqa: E402


class GateFailed(Exception):
    pass


def _fail(msg):
    raise GateFailed(msg)


DD_KERNELS = ("ozaki_split", "dd_accumulate", "dd_gemv", "dd_panel_chol",
              "dd_chol_solve")


def panels(seed, dev, dtype):
    """chip_smoke.panel_case's gates at every PANEL_SHAPES shape, and K14
    on grids of 1 and 3 CTAs bit for bit its default grid."""
    from sedumi_tpu_torch.parallel import panels as pn

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for bs, mp in cs.PANEL_SHAPES:
        c = cs.panel_case(bs, mp, gen, dev, dtype)
        tol = cs.PANEL_CASE[dtype]
        if not c["emu_ok"]:
            _fail(f"not the emulation's bits at bs={bs} {dtype}")
        if not (c["rel_l"] <= tol["tol"] and c["rel_x"] <= tol["tol"]
                and c["nan_ok"]):
            _fail(f"not the plain version's values at bs={bs} {dtype}")
        for j, C in enumerate(c["Cs"]):
            ref = pn.panel_chol_step(C, j)
            for ncta in (1, 3):
                got = pn._panel_chol_kernel(C, j, ncta)
                if not cs.bit_diff(got.cpu(), ref.cpu())[0]:
                    _fail(f"K14 on {ncta} CTAs differs at bs={bs} j={j}")
        out[bs] = c["rel_l"]
    return out


def arch0():
    from sedumi_tpu_torch.examples import load_example

    counts, info = cs.run_example(load_example("arch0"), True)
    cs.check_dd64_landing("arch0", counts, info, DD_KERNELS)
    return {k: v["iters"] for k, v in info["phases"].items()}


def control07_mixed():
    from sedumi_tpu_torch.examples import load_example

    _, info = cs.run_example(load_example("control07"), False,
                             {"dtype": "mixed"})
    cs.check_landing("control07 'mixed'", info,
                     *cs.MIXED_LANDINGS["control07"], cs.MIXED_SLACK)
    return {k: v["iters"] for k, v in info["phases"].items()}


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: smoke_repeat.py needs one card",
              file=sys.stderr)
        sys.exit(1)
    budget = float(sys.argv[1]) if len(sys.argv) > 1 else 240.0
    cs.fail = _fail
    from sedumi_tpu_torch import kernels

    t0 = time.time()
    kernels.build_all()
    print(f"built in {time.time() - t0:.1f}s", flush=True)
    dev = torch.device("cuda")
    log = []

    def attempt(label, fn, *args):
        t = time.time()
        try:
            got = fn(*args)
            log.append([label, "ok", round(time.time() - t, 2), got])
        except GateFailed as e:
            log.append([label, "FAIL " + str(e)[:400],
                        round(time.time() - t, 2)])
        except Exception:
            log.append([label, "EXC " + traceback.format_exc()[-800:],
                        round(time.time() - t, 2)])
        print(json.dumps(log[-1]), flush=True)

    i = 0
    t_start = time.time()
    while time.time() - t_start < budget:
        attempt(f"panels f64 {i}", panels, 20261016 + i, dev, torch.float64)
        attempt(f"panels f32 {i}", panels, 20261018 + i, dev, torch.float32)
        for k in range(3):
            attempt(f"arch0 f64 {i}.{k}", arch0)
        attempt(f"control07 mixed {i}", control07_mixed)
        i += 1
    print(json.dumps({"rounds": i, "checks": len(log),
                      "failed": [r for r in log if r[1] != "ok"]}))


if __name__ == "__main__":
    main()
