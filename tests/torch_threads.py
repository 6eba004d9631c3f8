"""One intra-op thread for the port's CPU tests of the synthesis layer (a
helper of the tests/test_torch_* files; pytest does not collect it).

The tracer and the on-device families run thousands of small tensor
operations. With the suite's six pytest workers on eight cores, torch's
default of one intra-op thread per core oversubscribes them, and every
small operation waits on the others' threads: the synthesis test files
took 783 s together under `-n 6`, 78 s with one thread each (measured on
the eight-core CPU runner). Import the fixture into a test module to use
it there; it restores the count when the module is done.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
