"""The port's command line (python -m sedumi_tpu_torch, __main__.main)
against the reference's (sedumi_tpu/__main__.py), on the CPU.

The options, their defaults, the JSON keys and the text lines are the
reference's, read from both sources.  In process, main([path, "--cpu",
"--json"]) on small SDPA and .mat files must print the summary of
sedumi(..., device="cpu") on the same arrays and save its x and y bit for
bit; without --cpu the solve asks for the CUDA device and raises on a
host without one, never falling back to the CPU.
"""

import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.io
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import sedumi_tpu_torch as pt  # noqa: E402
from sedumi_tpu_torch.__main__ import main  # noqa: E402
from sedumi_tpu_torch.generators import feasible_problem  # noqa: E402
from sedumi_tpu_torch.io_sdpa import read_sdpa, write_sdpa  # noqa: E402

# the suite runs in several worker processes: torch's CPU thread pool
# would spin on every core of each of them
torch.set_num_threads(1)

K_SMALL = {"l": 3, "s": [3, 2]}
# what main() passes to sedumi() by default
DEFAULT_PARS = {"eps": 1e-8, "maxiter": 150, "alg": 2}


def _cli_source(pkg: str) -> dict:
    """From a package's __main__.py: each add_argument's flag and keyword
    arguments, the keys of the JSON summary and the f-strings printed."""
    tree = ast.parse((ROOT / pkg / "__main__.py").read_text())
    args, keys, lines = {}, None, []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "add_argument":
            args[node.args[0].value] = {
                k.arg: ast.unparse(k.value) for k in node.keywords
                if k.arg != "help"}
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "dumps" and isinstance(node.args[0], ast.Dict):
            keys = [k.value for k in node.args[0].keys]
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "print" and isinstance(node.args[0], ast.JoinedStr):
            lines.append(ast.unparse(node.args[0]))
    return {"args": args, "keys": keys, "lines": lines}


def test_options_and_output_are_the_reference_cli():
    """The same options with the same defaults and choices, the same JSON
    keys in the same order, the same text lines."""
    assert _cli_source("sedumi_tpu_torch") == _cli_source("sedumi_tpu")


@pytest.fixture
def sdpa_file(tmp_path):
    At, b, c, _ = feasible_problem(K_SMALL, m=4, seed=7)
    path = str(tmp_path / "prob.dat-s")
    write_sdpa(path, At, b, c, K_SMALL)
    return path


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("quiet", [False, True])
def test_cpu_json_is_sedumi_on_the_cpu(sdpa_file, tmp_path, capsys, quiet):
    """main([file, --cpu, --json, --save]) returns 0 and prints the
    summary of sedumi() on the file's arrays on the CPU: c'x, b'y and the
    status fields equal, x and y saved bit for bit."""
    save = str(tmp_path / "xy.npz")
    argv = [sdpa_file, "--cpu", "--json", "--save", save] \
        + (["--quiet"] if quiet else [])
    assert main(argv) == 0
    got = _last_json(capsys.readouterr().out)
    At, b, c, K = read_sdpa(sdpa_file)
    x, y, info = pt.sedumi(At, b, c, K,
                           {**DEFAULT_PARS, "fid": 0 if quiet else 1},
                           device="cpu")
    capsys.readouterr()
    saved = np.load(save)
    np.testing.assert_array_equal(saved["x"], x)
    np.testing.assert_array_equal(saved["y"], y)
    assert got["cx"] == float(np.real(np.vdot(c, x)))
    assert got["by"] == float(np.real(np.vdot(b, y)))
    for k in ("iter", "pinf", "dinf", "numerr", "err"):
        assert got[k] == info[k], k
    assert got["wallsec"] > 0


def test_mat_file_and_text_output(tmp_path, capsys):
    """A .mat file with At, b, c and the K struct, as the bundled
    examples hold them: the text summary's three lines, with sedumi()'s
    values on the same arrays."""
    At, b, c, _ = feasible_problem(K_SMALL, m=4, seed=3)
    path = str(tmp_path / "prob.mat")
    K_struct = np.zeros((1, 1), dtype=[("l", "O"), ("s", "O")])
    K_struct[0, 0]["l"] = np.array([[3.0]])
    K_struct[0, 0]["s"] = np.array([[3.0, 2.0]])
    scipy.io.savemat(path, {"At": At, "b": b.reshape(-1, 1),
                            "c": c.reshape(-1, 1), "K": K_struct})
    assert main([path, "--cpu", "--quiet"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    x, y, info = pt.sedumi(At, b, c, K_SMALL, {**DEFAULT_PARS, "fid": 0},
                           device="cpu")
    assert lines == [
        f"c'x = {float(np.vdot(c, x)):.10e}",
        f"b'y = {float(np.vdot(b, y)):.10e}",
        f"iterations = {info['iter']}, pinf={info['pinf']}, "
        f"dinf={info['dinf']}, numerr={info['numerr']}"]


def test_without_cpu_the_card_is_asked_for(sdpa_file):
    """No --cpu: the solve asks for the CUDA device and raises here, with
    no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([sdpa_file, "--json", "--quiet"])
