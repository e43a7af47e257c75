"""Each cell on the card at its own size, briefly: the timed path agrees
with the plain reference, and the control (the reference in the precision
below the configuration's, in the program's place) does not.

    python -m pytest -m cuda framebench/tests/test_framebench_card.py
"""

from __future__ import annotations

import time

import pytest

from framebench.lib import bench


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["flagship-scan-1080p",
                                  "particles-collide-1080p"])
def test_cell_on_the_card(cuda_card, bench_json, cell):
    r = bench.run(cell, 2 ** 31 + 5, 3.0, False, "cuda", time.perf_counter(),
                  bench=bench_json, control=True)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert all(value > r["checks"][name]["limit"]
               for name, value in r["control"].items()), r["control"]
