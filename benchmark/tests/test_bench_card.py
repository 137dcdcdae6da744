"""The benchmark's command on the cards, as the driver runs it: each cell
once with a short window (correct, the card's name, no JAX), and each
one-chip cell's control at the cell's own size (not correct).  Skips
without the cards:

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_card.py
"""
import json
import subprocess
import sys

import pytest

from benchlib import BENCH, ROOT, SEED

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def cards(request):
    import torch

    need = request.param
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        pytest.skip(f"needs {need} CUDA card(s)")
    return need


def _chips(cell):
    return json.loads((ROOT / "BENCHMARK.json").read_text())[
        "workloads"][CELLS.index(cell)]["chips"]


def _run(*args, timeout=1200):
    res = subprocess.run([sys.executable, *args], cwd=ROOT, timeout=timeout,
                         capture_output=True, text=True)
    return res.returncode, res.stdout.strip().splitlines(), res.stderr


@pytest.mark.card
@pytest.mark.parametrize("cell, cards", [(c, _chips(c)) for c in CELLS],
                         indirect=["cards"])
def test_a_run_on_the_cards(cell, cards):
    rc, out, err = _run(str(BENCH / "run.py"), "--workload", cell, "--seed",
                        str(SEED), "--seconds", "3", "--trace", "0")
    assert rc == 0, err[-3000:]
    res = json.loads(out[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == cards
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.card
@pytest.mark.parametrize("cell, cards", [(c, 1) for c in CELLS
                                         if _chips(c) == 1],
                         indirect=["cards"])
def test_the_control_at_the_cells_size(cell, cards):
    rc, out, err = _run(str(BENCH / "control.py"), "--workload", cell,
                        "--seeds", str(SEED), "--seconds", "3")
    assert rc == 0, err[-3000:]
    res = json.loads(out[-1])
    assert not res["correct"], res["checks"]
