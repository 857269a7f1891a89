"""Thread count for the port's CPU tests.

Tier-1 runs six xdist workers on the machine's cores. Torch's default of
one intra-op thread per core in each worker oversubscribes the CPU, and
its spinning threads slowed the port's small-tensor epoch loop ~80x when
five such processes ran at once (E1C scene of test_torch_pilot_receiver:
~1 000 s of tracking each, against ~12 s on two threads each). The port's
test modules import ``few_torch_threads``; subprocesses get ``THREADS``
through ``OMP_NUM_THREADS``.
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def test_module_fixture_sets_the_thread_count():
    assert torch.get_num_threads() == THREADS
