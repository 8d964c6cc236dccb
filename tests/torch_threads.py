"""One PyTorch intra-op thread for the port's CPU tests.

The port's tests run tiny shapes, usually beside other test processes
(pytest-xdist workers).  With PyTorch's default of one OpenMP thread per
core, every op's threads then wait on each other for the busy cores:
`test_torch_pipeline.py::test_live_switches_apply_at_the_next_frame` took
1.25 s with one thread and 71 s with eight on an 8-core host beside seven
busy processes.  Each `test_torch_*` module imports `one_torch_thread`, an
autouse fixture that sets one thread for the module and restores the count
after it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
