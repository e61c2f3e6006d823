"""The port's fault injection on the CPU, (a) of `test_torch_faults.py`
for the drained step: `CRASH_HEAVY`, `PART_HEAVY` and `DEGRADE_HEAVY` with
replicas as one 6-lane grid through `run_grid(device="cpu")`, every final
leaf bitwise the reference's vmap lanes, every leaf but `fused` its map
lanes, the drain stats equal. In a file of its own so that pytest-xdist
(`--dist loadfile`) can run it beside the rest.
"""

import pytest

from test_torch_faults import check_faulted_grid
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("drain", [True], ids=["drained"])
def test_faulted_grid_matches_reference_lanes(drain):
    check_faulted_grid(drain)
