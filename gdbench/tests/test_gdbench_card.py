"""On the card: each cell runs once, short, and reads correct; the
control reads not correct at the cell's own size.  Skips without a card;
on the card's machine, from the checkout's root:
    python -m pytest gdbench/tests -m cuda -q
"""
import json
import subprocess
import sys

import pytest

from gdbench import registry

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(card, name):
    out = subprocess.run(
        [sys.executable, "-m", "gdbench.run", "--workload", name, "--seed",
         str(2**31 + 99), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=registry.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = _last_json(out.stdout)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_at_the_cells_size_is_not_correct(card, name):
    out = subprocess.run(
        [sys.executable, "-m", "gdbench.readings", "--workload", name,
         "--control-seeds", "7"],
        capture_output=True, text=True, cwd=registry.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    nums = _last_json(out.stdout)["numbers"]
    limits = registry.cell(name).limits
    assert any(v > limits[k] for k, v in nums.items()), nums
